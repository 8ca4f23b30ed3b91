"""Build or check dataset CSV manifests without pandas (the port's
counterpart of `scripts/build_dataset_csvs.py`, whose flags it takes):

    python -m madeleine_torch.tools.build_dataset_csvs --scan_features <bag dir> \
        [--dataset ACROBAT] [--out <csv> | --out_root dataset_csv]
    python -m madeleine_torch.tools.build_dataset_csvs --from_reference <checkout>

- ``--scan_features``: an ACROBAT-style manifest from the names of
  ``{slide_id}_{stain}[_{split}].(h5|npz)`` bag files (names only: no bag is
  opened), one row a case: ``slide_id``, a 0/1 column a stain of the
  dataset (`config.MODALITY_DICTS`, ``HE`` alone for another dataset) and
  ``split`` (``train`` unless a file names one), in the columns and bytes
  pandas' ``DataFrame.to_csv(index=False)`` writes for the same rows.
- ``--from_reference``: copies ``dataset_csv/{ACROBAT,BCNB}/*.csv`` from a
  reference checkout and checks their required columns.
"""

from __future__ import annotations

import argparse
import csv
import os
import re
import shutil
from typing import Dict, List, Optional, Sequence

from madeleine_torch.config import MODALITY_DICTS

REQUIRED = {
    "ACROBAT": ["slide_id", "HE", "HER2", "PGR", "KI67", "ER", "split"],
    "BCNB": ["slide_id", "er", "pr", "her2"],
}


def validate(path: str, dataset: str) -> None:
    """Exit naming the required columns `path` lacks; else print its row count."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader, [])
        n_rows = sum(1 for row in reader if row)   # blank lines are no rows, as in pandas
    missing = [c for c in REQUIRED[dataset] if c not in header]
    if missing:
        raise SystemExit(f"{path}: missing columns {missing}")
    print(f"* {path}: {n_rows} rows, schema OK")


def from_reference(ref_dir: str, out_root: str) -> None:
    for dataset in ("ACROBAT", "BCNB"):
        src = os.path.join(ref_dir, "dataset_csv", dataset, f"{dataset}.csv")
        if not os.path.exists(src):
            print(f"* {src} not found, skipping")
            continue
        dst_dir = os.path.join(out_root, dataset)
        os.makedirs(dst_dir, exist_ok=True)
        dst = os.path.join(dst_dir, f"{dataset}.csv")
        shutil.copy(src, dst)
        validate(dst, dataset)


def scan_features(feat_dir: str, dataset: str, out: str) -> None:
    stains = MODALITY_DICTS.get(dataset, ["HE"])
    pat = re.compile(r"^(?P<sid>.+?)_(?P<stain>" + "|".join(stains) +
                     r")(?:_(?P<split>\w+))?\.(h5|npz)$")
    cases: Dict[str, Dict[str, object]] = {}
    for fn in sorted(os.listdir(feat_dir)):
        m = pat.match(fn)
        if not m:
            continue
        sid = m.group("sid")
        row = cases.setdefault(sid, {"slide_id": sid, **{s: 0 for s in stains},
                                     "split": "train"})
        row[m.group("stain")] = 1
        if m.group("split"):
            row["split"] = m.group("split")
    if not cases:
        raise SystemExit(f"no bag files matching {stains} in {feat_dir}")
    rows: List[Dict[str, object]] = list(cases.values())
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]), lineterminator="\n")
        writer.writeheader()
        writer.writerows(rows)
    print(f"* Wrote {out}: {len(rows)} cases")
    if dataset in REQUIRED:
        validate(out, dataset)


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--from_reference", type=str, default=None)
    p.add_argument("--scan_features", type=str, default=None)
    p.add_argument("--dataset", type=str, default="ACROBAT")
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--out_root", type=str, default="dataset_csv")
    args = p.parse_args(argv)

    if args.from_reference:
        from_reference(args.from_reference, args.out_root)
    elif args.scan_features:
        out = args.out or os.path.join(args.out_root, args.dataset, f"{args.dataset}.csv")
        scan_features(args.scan_features, args.dataset, out)
    else:
        p.error("pass --from_reference or --scan_features")


if __name__ == "__main__":
    main()
