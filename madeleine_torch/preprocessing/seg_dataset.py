"""Segmentation tile datasets (JAX: madeleine_tpu/preprocessing/seg_dataset.py;
ref: preprocessing/hest_modules/SegDataset.py:11-73).

Batched iterators feeding patcher tiles (col/row ordered) into a segmentation
model, plus a file-backed variant reading pre-extracted tiles from disk.
Host-side numpy batches, as in the JAX package; both yield (tiles [n, s, s, 3] uint8,
coords [n, 2] level-0 xy).
"""

from __future__ import annotations

import os
from typing import Iterator, Tuple

import numpy as np

from madeleine_torch.preprocessing.patching import WSIPatcher


class SegWSIDataset:
    """Tiles straight from a WSIPatcher (ref: SegDataset.py:11-46)."""

    def __init__(self, patcher: WSIPatcher, batch_size: int = 64):
        self.patcher = patcher
        self.batch_size = batch_size

    def __len__(self) -> int:
        return len(self.patcher)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        tiles, coords = [], []
        for tile, x, y in self.patcher:
            tiles.append(tile)
            coords.append((x, y))
            if len(tiles) >= self.batch_size:
                yield np.stack(tiles), np.asarray(coords, np.int64)
                tiles, coords = [], []
        if tiles:
            yield np.stack(tiles), np.asarray(coords, np.int64)


class SegFileDataset:
    """Tiles from image files on disk named ``<x>_<y>.<ext>``
    (ref: SegDataset.py:49-73)."""

    def __init__(self, tile_dir: str, batch_size: int = 64,
                 exts=(".png", ".jpg", ".jpeg")):
        self.tile_dir = tile_dir
        self.batch_size = batch_size
        self.fnames = sorted(fn for fn in os.listdir(tile_dir)
                             if fn.lower().endswith(exts))

    def __len__(self) -> int:
        return len(self.fnames)

    @staticmethod
    def _coords_of(fname: str) -> Tuple[int, int]:
        stem = os.path.splitext(fname)[0]
        try:
            x, y = stem.split("_")[-2:]
            return int(x), int(y)
        except ValueError:
            return (0, 0)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        from PIL import Image

        tiles, coords = [], []
        for fn in self.fnames:
            img = np.asarray(Image.open(os.path.join(self.tile_dir, fn))
                             .convert("RGB"))
            tiles.append(img)
            coords.append(self._coords_of(fn))
            if len(tiles) >= self.batch_size:
                yield np.stack(tiles), np.asarray(coords, np.int64)
                tiles, coords = [], []
        if tiles:
            yield np.stack(tiles), np.asarray(coords, np.int64)
