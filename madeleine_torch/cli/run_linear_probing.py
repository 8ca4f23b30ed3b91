"""Few-shot linear probing on slide embeddings (ref: bin/run_linear_probing.py).

Usage (the JAX package's flags, plus --device):
    python -m madeleine_torch.cli.run_linear_probing \
        --slide_embedding_pkl ../results/BCNB/madeleine_slide_embeddings.pkl \
        --label_path ../dataset_csv/BCNB/BCNB.csv [--tasks er pr] [--device cuda]

The tasks default from the CSV's name (BCNB: er, pr, her2). Writes
``res_linear_probing/<pkl name>/k=<k>_probing_<task>.pickle`` beside the pkl.
"""

from __future__ import annotations

import argparse
import os

from madeleine_torch.eval.linear_probe import BCNB_BREAST_TASKS, eval_single_task
from madeleine_torch.utils.device import resolve_device


def main(argv=None, record=None):
    """Run the sweep; returns eval_single_task's metric stores (`record`: see
    eval_single_task)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--slide_embedding_pkl", type=str, default=None)
    parser.add_argument("--label_path", type=str, default=None)
    parser.add_argument("--tasks", type=str, nargs="*", default=None,
                        help="override task list (default inferred from csv name)")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    d_name = os.path.splitext(os.path.basename(args.label_path))[0]
    if args.tasks:
        tasks = args.tasks
    elif d_name == "BCNB":
        tasks = BCNB_BREAST_TASKS
    else:
        raise NotImplementedError(
            "Unknown dataset csv; pass --tasks to specify label columns.")

    print(f"* Evaluating on {tasks} status in {d_name}...")
    metrics = eval_single_task(embeds_path=args.slide_embedding_pkl,
                               label_path=args.label_path, tasks=tasks, verbose=True,
                               device=device, record=record)
    print("\n" + 100 * "-" + "\nEnd of experiment, bye!\n" + 100 * "-")
    return metrics


if __name__ == "__main__":
    main()
