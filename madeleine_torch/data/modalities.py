"""Dataset -> ordered stain list registry (ref: madeleine/datasets/modalities.py:1-3).

The port's own copy of `madeleine_tpu/data/modalities.py`. HE is always
index 0 (HE_POSITION); register new cohorts with `register_modalities`.
"""

from __future__ import annotations

from typing import List

from madeleine_torch.config import MODALITY_DICTS as modality_dicts


def register_modalities(dataset: str, stains: List[str]) -> None:
    if not stains or stains[0] != "HE":
        raise ValueError("modality lists must start with 'HE' (HE_POSITION=0)")
    modality_dicts[dataset] = list(stains)
