"""Render per-slide attention heatmaps from a MADELEINE checkpoint (ref:
bin/extract_attention_maps.py).

Usage (the JAX package's flags, plus --device):
    python -m madeleine_torch.cli.extract_attention_maps --local_dir <dir with patch_embeddings/> \
        --model_dir ./../models [--head N] [--out_dir heatmaps] [--no_download] [--device cuda]

For each bag that carries ``coords`` (``.bag``, ``.npz``; ``.h5`` where
h5py imports), `encode_with_attention` gives the raw per-head attention
logits (the plain route, as the JAX package's use_pallas=False), one bag
at a time on the device in the checkpoint's compute dtype (the JAX CLI
feeds float32 whatever the checkpoint's precision), and a softmax heatmap
PNG is written per slide.
"""

from __future__ import annotations

import argparse
import os

import torch

from madeleine_torch.data.io import list_bags, load_coords, load_features
from madeleine_torch.eval.heatmap import save_heatmap
from madeleine_torch.models.factory import create_model_from_pretrained
from madeleine_torch.models.madeleine import encode_with_attention


def main(argv=None) -> dict:
    """Write the maps; returns {"out_dir", "maps": {slide id: png path},
    "logits": {slide id: raw logits [t, n_heads] float32}}."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--local_dir", type=str, required=True)
    parser.add_argument("--model_dir", type=str, default="./../models")
    parser.add_argument("--out_dir", type=str, default=None)
    parser.add_argument("--head", type=int, default=None,
                        help="head index (default: mean over heads)")
    parser.add_argument("--patch_size", type=int, default=256,
                        help="patch pitch in level-0 px (for grid layout)")
    parser.add_argument("--no_download", action="store_true")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    _, model, dtype = create_model_from_pretrained(
        os.path.join(args.model_dir, "MADELEINE"), download=not args.no_download,
        device=args.device)
    device = next(model.parameters()).device

    feat_dir = os.path.join(args.local_dir, "patch_embeddings")
    if not os.path.isdir(feat_dir):
        feat_dir = args.local_dir
    out_dir = args.out_dir or os.path.join(args.local_dir, "attention_maps")
    os.makedirs(out_dir, exist_ok=True)

    maps, logits = {}, {}
    for fn in list_bags(feat_dir):
        path = os.path.join(feat_dir, fn)
        coords = load_coords(path)
        if coords is None:
            print(f"* {fn}: no coords, skipping")
            continue
        feats = torch.tensor(load_features(path))[None].to(device, dtype)
        _, raw = encode_with_attention(model, feats)
        sid = os.path.splitext(fn)[0]
        logits[sid] = raw[0].float().cpu().numpy()
        maps[sid] = save_heatmap(os.path.join(out_dir, f"{sid}.png"), coords, logits[sid],
                                 args.patch_size, head=args.head)
    print(f"* Wrote {len(maps)} attention maps to {out_dir}")
    return {"out_dir": out_dir, "maps": maps, "logits": logits}


if __name__ == "__main__":
    main()
