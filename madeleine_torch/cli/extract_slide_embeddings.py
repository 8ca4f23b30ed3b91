"""Extract MADELEINE slide embeddings for a directory of patch-embedding bags.

Usage (flags of ref: bin/extract_slide_embeddings.py, plus --device):
    python -m madeleine_torch.cli.extract_slide_embeddings --local_dir ../results/BCNB/ \
        [--model_dir ./../models] [--no_download] [--device cuda]

Reads ``<local_dir>/patch_embeddings/*.{npz,bag,h5}`` (or ``<local_dir>``
itself), encodes them with ``<model_dir>/MADELEINE``, and writes
``<local_dir>/madeleine_slide_embeddings.pkl`` = {"embeds", "slide_ids"}.
"""

from __future__ import annotations

import argparse
import os

from madeleine_torch.eval.inference import get_downstream_loader, run_inference
from madeleine_torch.models.factory import create_model_from_pretrained
from madeleine_torch.utils.file_utils import save_pkl


def main(argv=None) -> str:
    """Run the extraction; returns the path of the written pkl."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--local_dir", type=str, required=True)
    parser.add_argument("--model_dir", type=str, default="./../models")
    parser.add_argument("--no_download", action="store_true",
                        help="use local checkpoint files only")
    parser.add_argument("--tokens_per_batch", type=int, default=262144)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    _, model, dtype = create_model_from_pretrained(
        os.path.join(args.model_dir, "MADELEINE"), download=not args.no_download,
        device=args.device)
    loader = get_downstream_loader(args.local_dir, tokens_per_batch=args.tokens_per_batch)
    results, rank = run_inference(model, loader, dtype=dtype, device=args.device)
    out = os.path.join(args.local_dir, "madeleine_slide_embeddings.pkl")
    save_pkl(out, results)
    print(f"* Saved {len(results['slide_ids'])} embeddings (rank={rank:.2f}) to {out}")
    return out


if __name__ == "__main__":
    main()
