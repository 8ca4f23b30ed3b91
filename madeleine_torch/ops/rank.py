"""Smooth rank measure: exp(entropy of the L1-normalised singular values)
(ref: utils.py:180-201), the reference's model-selection metric."""

from __future__ import annotations

import torch


def smooth_rank_measure(embedding_matrix: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """embedding_matrix [n, m] -> scalar f32. Keeps the reference's
    ``p = p[:m]`` slice, which only matters when n < m."""
    x = embedding_matrix.float()
    s = torch.linalg.svdvals(x)
    p = s / s.abs().sum() + eps
    p = p[: x.shape[1]]
    return torch.exp(-torch.sum(p * torch.log(p)))
