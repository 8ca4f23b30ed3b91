"""Convert reference-schema bags (``.h5`` where h5py imports, ``.npz``) to the
native ``.bag`` format that the pretrain CLI's native loader reads (port of
scripts/convert_bags.py; the same bytes as the JAX package's
`convert_to_bag`, coords kept where the source has them).

Usage:
    python -m madeleine_torch.cli.convert_bags --src <dir of bags> [--dst <dir>] \
        [--dtype float32|bfloat16]

bfloat16 halves disk and host-memory traffic; the features are rounded
half-up to bf16, which a bf16 training run would do anyway.
"""

from __future__ import annotations

import argparse
import os

from madeleine_torch.data.io import list_bags
from madeleine_torch.native.bagio import convert_to_bag


def main(argv=None) -> str:
    """Convert every bag of --src; returns the destination dir."""
    p = argparse.ArgumentParser(description="Convert bags to the native .bag format")
    p.add_argument("--src", type=str, required=True)
    p.add_argument("--dst", type=str, default=None)
    p.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    args = p.parse_args(argv)

    dst_dir = args.dst or args.src
    os.makedirs(dst_dir, exist_ok=True)
    files = list(list_bags(args.src))
    for i, fn in enumerate(files):
        dst = os.path.join(dst_dir, os.path.splitext(fn)[0] + ".bag")
        convert_to_bag(os.path.join(args.src, fn), dst, dtype=args.dtype)
        if (i + 1) % 200 == 0:
            print(f"* {i + 1}/{len(files)}")
    print(f"* Converted {len(files)} bags -> {dst_dir}")
    return dst_dir


if __name__ == "__main__":
    main()
