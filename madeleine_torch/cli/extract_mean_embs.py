"""Mean-of-patch-embeddings baseline (ref: bin/extract_mean_embs.py).

Usage (the JAX package's flags, plus --device):
    python -m madeleine_torch.cli.extract_mean_embs --local_dir ../results/BCNB/ [--device cuda]

Reads ``<local_dir>/patch_embeddings/*.{npz,bag,h5}`` (or ``<local_dir>``
itself; ``.h5`` where h5py imports) and writes
``<local_dir>/mean_slide_embeddings.pkl`` = {"embeds", "slide_ids"}, the
MADELEINE embeddings' schema, for the CONCH-mean baseline. Each mean is
taken on the device in float32.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from madeleine_torch.data.io import list_bags, load_features
from madeleine_torch.utils.device import resolve_device
from madeleine_torch.utils.file_utils import save_pkl


def main(argv=None) -> str:
    """Write the pkl; returns its path."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--local_dir", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    path_to_patches = os.path.join(args.local_dir, "patch_embeddings")
    if not os.path.isdir(path_to_patches):
        path_to_patches = args.local_dir

    means, all_ids = [], []
    for fn in list_bags(path_to_patches):
        feats = torch.tensor(load_features(os.path.join(path_to_patches, fn)))
        means.append(feats.to(device).mean(dim=0))
        all_ids.append(os.path.splitext(fn)[0])
    embeds = torch.stack(means).cpu().numpy() if means else np.zeros(0, np.float32)

    os.makedirs(args.local_dir, exist_ok=True)
    out = os.path.join(args.local_dir, "mean_slide_embeddings.pkl")
    save_pkl(out, {"embeds": embeds, "slide_ids": all_ids})
    print(f"* Saved {len(all_ids)} mean embeddings")
    return out


if __name__ == "__main__":
    main()
