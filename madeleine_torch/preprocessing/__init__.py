"""Tile preprocessing: the ViT tile encoder (`vit.py`)."""
