"""Masked attention pooling (ref: Model.py:406-417 + abmil.py:54-63).

Per-head activation of raw attention logits over the token axis, then the
attention-weighted sum of that head's token features:

    pooled[b, h, e] = sum_t act_t(logits[b, :, h])[t] * x[b, t, h, e]

Token features are head-major ``[b, t, nh, e]``, as in the JAX package. The
JAX package's streaming Pallas pool (`attn_pool.py::_pool_kernel`) lies off
the serving path and is not ported yet; this module holds the plain version
(any activation) and the mask helpers the two kernels share.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30  # finite mask fill: keeps the online-softmax recurrence NaN-free
MASKED_BIAS = -1e29  # a logit at or below this belongs to a masked token


def _normalize_mask(mask: Optional[torch.Tensor], b: int, t: int) -> Optional[torch.Tensor]:
    """Broadcast any of [t], [1, t], [b, t] to a [b, t] bool tensor."""
    if mask is None:
        return None
    mask = torch.as_tensor(mask).to(torch.bool)
    if mask.ndim == 1:
        mask = mask[None, :]
    return mask.expand(b, t)


def mask_bias(mask: Optional[torch.Tensor], b: int, t: int, nh: int,
              device: torch.device) -> torch.Tensor:
    """Additive [b, t, nh] f32 logit bias: 0 on valid tokens, NEG_INF on
    padding (the layout both kernels read, encode_fused.py:268-274)."""
    m = _normalize_mask(mask, b, t)
    if m is None:
        return torch.zeros(b, t, nh, dtype=torch.float32, device=device)
    bias = torch.where(m.to(device), 0.0, NEG_INF).to(torch.float32)
    return bias[..., None].expand(b, t, nh).contiguous()


def activate_attention(logits: torch.Tensor, activation: str,
                       mask: Optional[torch.Tensor] = None,
                       dim: int = -2) -> torch.Tensor:
    """Token-axis activation of raw scores (ref: abmil.py:54-63), padding
    aware: softmax renormalises over valid tokens, elementwise activations are
    zeroed on padding."""
    if activation == "softmax":
        l32 = logits.float()
        if mask is not None:
            l32 = l32.masked_fill(~mask, float("-inf"))
        out = torch.softmax(l32, dim=dim)
        if mask is not None:
            out = out.masked_fill(~mask, 0.0)  # all-masked rows: softmax -> nan
        return out.to(logits.dtype)
    if activation == "relu":
        out = torch.relu(logits)
    elif activation == "leaky_relu":
        out = torch.nn.functional.leaky_relu(logits)
    elif activation == "sigmoid":
        out = torch.sigmoid(logits)
    else:
        raise NotImplementedError(f"Activation not implemented: {activation}")
    if mask is not None:
        out = out.masked_fill(~mask, 0.0)
    return out


def _pool_reference(xh: torch.Tensor, logits: torch.Tensor,
                    mask: Optional[torch.Tensor], activation: str) -> torch.Tensor:
    """xh [b, t, nh, e], logits [b, t, nh], mask [b, t] -> pooled [b, nh, e]."""
    m = None if mask is None else mask[..., None]
    attn = activate_attention(logits, activation, m, dim=-2)
    pooled = torch.einsum("bthe,bth->bhe", xh.float(), attn.float())
    return pooled.to(xh.dtype)


def softmax_pool_plain(logits: torch.Tensor, yh: torch.Tensor) -> torch.Tensor:
    """Per-head softmax pool as the kernels compute it, in f32: logits
    [b, t, nh] (mask bias already added), yh [b, t, nh, e] -> [b, nh*e].
    A bag with no unmasked token pools to 0, as in the kernels, which skip
    such tiles (the TPU kernels pool it uniformly; either way it is finite
    and the rows of real bags are unaffected)."""
    m = logits.amax(dim=1, keepdim=True)
    p = torch.exp(logits - m)
    s = p.sum(dim=1)
    w = torch.einsum("bth,bthe->bhe", p, yh.float())
    live = (m[:, 0] > MASKED_BIAS)[..., None]
    return torch.where(live, w / s.clamp_min(1e-30)[..., None], 0.0).reshape(yh.shape[0], -1)


def masked_attention_pool(xh: torch.Tensor, logits: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          activation: str = "softmax") -> torch.Tensor:
    """Masked per-head pooling, any activation -> [b, nh, e]."""
    b, t = xh.shape[:2]
    return _pool_reference(xh, logits, _normalize_mask(mask, b, t), activation)
