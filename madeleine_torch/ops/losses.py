"""Contrastive loss (InfoNCE) of the train step, in float32.

PyTorch counterpart of `madeleine_tpu/ops/losses.py:49-106` (ref:
madeleine/utils/loss.py:65-127): temperature-scaled contrastive cross-entropy
with in-batch negatives, an optional symmetric variant, a validity mask that
replaces the reference's boolean subsetting, and the explicit-negatives
modes (which the reference falls through without returning; here they
return the cross-entropy over [positive | negatives]).

Everything runs in f32 with full-precision products (no TF32, see
`utils.device.full_precision_matmul`): temperature 0.001 multiplies logit
noise by 1000. GOT (`got_loss`, `got_loss_multi`) is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

_EPS_NORM = 1e-12
_NEG_INF = -1e30  # finite mask fill: keeps gradients NaN-free


def _l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """torch F.normalize semantics: x / max(||x||, eps)."""
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(_EPS_NORM)


def _masked_ce_diag(logits: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean CE with diagonal labels; invalid rows dropped, invalid columns
    excluded from the denominator (equal to subsetting the valid entries)."""
    if mask is not None:
        logits = torch.where(mask[None, :], logits, torch.full_like(logits, _NEG_INF))
    ce = torch.logsumexp(logits, dim=1) - torch.diagonal(logits)
    if mask is None:
        return ce.mean()
    denom = mask.sum().clamp_min(1)
    return torch.where(mask, ce, torch.zeros_like(ce)).sum() / denom


def info_nce(query: torch.Tensor, positive_key: torch.Tensor,
             negative_keys: Optional[torch.Tensor] = None, *, temperature: float = 0.1,
             symmetric: bool = False, mask: Optional[torch.Tensor] = None,
             negative_mode: str = "unpaired") -> torch.Tensor:
    """InfoNCE (ref: loss.py:65-127). query, positive_key [n, d]; mask [n]
    bool marks the valid rows and columns. f32 throughout."""
    q = _l2_normalize(query.float())
    k = _l2_normalize(positive_key.float())
    if negative_keys is not None:
        nk = _l2_normalize(negative_keys.float())
        pos = (q * k).sum(dim=1, keepdim=True)
        if negative_mode == "unpaired":
            neg = q @ nk.T
        elif negative_mode == "paired":
            neg = torch.einsum("nd,nmd->nm", q, nk)
        else:
            raise ValueError(f"bad negative_mode {negative_mode}")
        logits = torch.cat([pos, neg], dim=1) / temperature
        ce = torch.logsumexp(logits, dim=1) - logits[:, 0]
        if mask is None:
            return ce.mean()
        return torch.where(mask, ce, torch.zeros_like(ce)).sum() / mask.sum().clamp_min(1)
    logits = (q @ k.T) / temperature
    loss = _masked_ce_diag(logits, mask)
    if symmetric:
        loss = 0.5 * loss + 0.5 * _masked_ce_diag(logits.T, mask)
    return loss
