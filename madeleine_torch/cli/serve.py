"""Serve MADELEINE slide embeddings over HTTP.

Usage:
    python -m madeleine_torch.cli.serve --model_dir ./../models [--port 8000] \
        [--max_batch 32] [--device cuda]

Reads ``<model_dir>/MADELEINE/{model_config.json, model.pt}``. POST /encode
with an .npz body ({"features": [n, d]}) or raw f32 bytes + X-Rows/X-Cols
headers returns {"embedding": [...]}; GET /healthz, /stats.
"""

from __future__ import annotations

import argparse
import os

from madeleine_torch.models.factory import create_model_from_pretrained
from madeleine_torch.serve.server import serve


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_dir", type=str, default="./../models")
    parser.add_argument("--host", type=str, default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--max_batch", type=int, default=32)
    parser.add_argument("--max_wait_ms", type=float, default=5.0)
    parser.add_argument("--no_download", action="store_true")
    parser.add_argument("--warmup", action="store_true",
                        help="run every bucket shape once before serving")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    _, model, _ = create_model_from_pretrained(
        os.path.join(args.model_dir, "MADELEINE"), download=not args.no_download,
        device=args.device)
    serve(model, host=args.host, port=args.port, warmup=args.warmup, device=args.device,
          max_batch=args.max_batch, max_wait_ms=args.max_wait_ms)


if __name__ == "__main__":
    main()
