"""Masked attention pooling (ref: Model.py:406-417 + abmil.py:54-63), and
kernel K3, the streaming softmax pool.

Per-head activation of raw attention logits over the token axis, then the
attention-weighted sum of that head's token features:

    pooled[b, h, e] = sum_t act_t(logits[b, :, h])[t] * x[b, t, h, e]

Token features are head-major ``[b, t, nh, e]``, as in the JAX package.
K3 replaces `madeleine_tpu/ops/attn_pool.py::_pool_kernel` (csrc/attn_pool.cu):
softmax over pre-masked f32 logits, any bag length, pooled in f32 and
written in y's dtype. `softmax_pool` is K3's op; its plain version is
`softmax_pool_plain`, the one-pass pool K1 and K2 share. `masked_attention_pool`
is the plain pool of any activation (the JAX package's XLA route);
`models/abmil.py` picks between the two. The module also holds the mask
helpers the kernels share.
"""

from __future__ import annotations

from typing import Optional

import torch

from madeleine_torch.ops import _build

NEG_INF = -1e30  # finite mask fill: keeps the online-softmax recurrence NaN-free
MASKED_BIAS = -1e29  # a logit at or below this belongs to a masked token

launches = 0  # K3 launches (one per wrapper call on a CUDA tensor)


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
    """Per-head softmax pool as the kernels K1-K3 compute it, in f32: logits
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


@torch.no_grad()
def attn_pool_cuda(y: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """Launch K3 on CUDA tensors: y [b, t, E] bf16 or f32, l [b, t, nh] f32
    -> pooled [b, E] in y's dtype."""
    global launches
    if y.device.type != "cuda":
        raise ValueError(f"attn_pool kernel needs CUDA tensors, got {y.device}")
    if y.dtype not in (torch.bfloat16, torch.float32) or y.ndim != 3 or l.ndim != 3:
        raise ValueError(f"attn_pool kernel: y must be a bf16 or f32 [b, t, E] tensor, got "
                         f"{y.dtype} {tuple(y.shape)}")
    b, t, E = y.shape
    nh = l.shape[-1]
    vec = 8 if y.dtype == torch.bfloat16 else 4     # 16-byte loads
    if b < 1 or t < 1 or nh < 1 or E % nh or (E // nh) % vec or nh > 32:
        raise ValueError(f"attn_pool kernel: unsupported shape y {tuple(y.shape)}, nh={nh} "
                         f"(needs nh <= 32 heads of width a multiple of {vec})")
    _build.check_operand("attn_pool", "y", y, (b, t, E), y.dtype, y.device)
    _build.check_operand("attn_pool", "l", l, (b, t, nh), torch.float32, y.device)
    out = _build.launch_split_pool("attn_pool", [y, l],
                                   (b, t, nh, E // nh, int(y.dtype == torch.bfloat16)),
                                   b, t, nh, E, y.dtype)
    launches += 1
    return out


def softmax_pool(xh: torch.Tensor, logits: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3's op, the softmax pool of JAX attn_pool.py:343-352: logits masked
    to NEG_INF in f32, then the kernel over the flat [b, t, nh*e] view of a
    CUDA tensor, its plain version `softmax_pool_plain` on a CPU one ->
    [b, nh, e] in xh's dtype."""
    b, t, nh, e = xh.shape
    mask = _normalize_mask(mask, b, t)
    l32 = logits.float()
    if mask is not None:
        l32 = l32.masked_fill(~mask[..., None].to(l32.device), NEG_INF)
    if xh.device.type == "cpu":
        return softmax_pool_plain(l32, xh).to(xh.dtype).reshape(b, nh, e)
    return attn_pool_cuda(xh.reshape(b, t, nh * e).contiguous(),
                          l32.contiguous()).reshape(b, nh, e)


def masked_attention_pool(xh: torch.Tensor, logits: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          activation: str = "softmax") -> torch.Tensor:
    """Masked per-head pooling, any activation, the plain way -> [b, nh, e]
    (the JAX package's use_pallas=False route)."""
    b, t = xh.shape[:2]
    return _pool_reference(xh, logits, _normalize_mask(mask, b, t), activation)
