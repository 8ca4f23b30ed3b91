"""Seeding of the host generators (ref: madeleine/utils/utils.py:147-177).

The train step's randomness is keyed explicitly (dropout masks and GOT
subsamples by the step's seed, the loader by (seed, epoch)); this seeds
Python's, numpy's and torch's global generators as the reference does, for
anything else that draws from them.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def set_deterministic_mode(seed: int) -> np.random.Generator:
    """Seed the global generators; returns a fresh numpy Generator."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return np.random.default_rng(seed)
