"""Fused gated-attention scoring + softmax pooling (kernel K2, f32).

Replaces `madeleine_tpu/ops/gated_pool.py::_gated_pool_kernel`. After the
pre-attention MLP, per head h:

    l_h    = (tanh(y_h Wa_h^T + ba_h) * sigmoid(y_h Wb_h^T + bb_h)) . wc_h + bc_h
    pooled = sum_t softmax_t(l_h + mask_bias)[t] * y_h[t]

all in f32 (the parity route: Precision.HIGHEST on the TPU, plain FP32 FMA
here; see csrc/gated_pool.cu). A CPU tensor takes the plain PyTorch version;
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from madeleine_torch.ops import _build
from madeleine_torch.ops.attn_pool import mask_bias, softmax_pool_plain

launches = 0  # kernel launches (one per wrapper call on a CUDA tensor)

_GATE_KEYS = ("wa", "ba", "wb", "bb", "wc", "bc")


@torch.no_grad()
def gated_attention_pool_plain(y, bias, wa, ba, wb, bb, wc, bc) -> torch.Tensor:
    """y [b, t, nh*e] f32 head-major, bias [b, t, nh] f32, wa/wb [nh, f, e],
    ba/bb/wc [nh, f], bc [nh] -> pooled [b, nh*e] f32."""
    b, t, E = y.shape
    nh, f, e = wa.shape
    yh = y.reshape(b, t, nh, e)
    a = torch.tanh(torch.einsum("bthe,hfe->bthf", yh, wa) + ba)
    g = torch.sigmoid(torch.einsum("bthe,hfe->bthf", yh, wb) + bb)
    logits = torch.einsum("bthf,hf->bth", a * g, wc) + bc + bias
    return softmax_pool_plain(logits, yh)


@torch.no_grad()
def gated_pool_cuda(y, bias, wa, ba, wb, bb, wc, bc) -> torch.Tensor:
    """Launch kernel K2 on CUDA tensors (shapes as the plain version)."""
    global launches
    if y.device.type != "cuda":
        raise ValueError(f"gated_pool kernel needs CUDA tensors, got {y.device}")
    b, t, E = y.shape
    nh, f, e = wa.shape
    if E != nh * e or e % 16 or f % 64 or t < 1 or b < 1:
        raise ValueError(f"gated_pool kernel: unsupported shape y {tuple(y.shape)}, "
                         f"wa {tuple(wa.shape)} (needs e % 16 == 0, f % 64 == 0)")
    operands = (("y", y, (b, t, E)), ("bias", bias, (b, t, nh)),
                ("wa", wa, (nh, f, e)), ("ba", ba, (nh, f)),
                ("wb", wb, (nh, f, e)), ("bb", bb, (nh, f)),
                ("wc", wc, (nh, f)), ("bc", bc, (nh,)))
    for name, x, shape in operands:
        _build.check_operand("gated_pool", name, x, shape, torch.float32, y.device)
    out = _build.launch_split_pool("gated_pool", [x for _, x, _ in operands],
                                   (b, t, nh, e, f), b, t, nh, E, torch.float32)
    launches += 1
    return out


@torch.no_grad()
def gated_attention_pool(attn: Dict[str, torch.Tensor], xh: torch.Tensor,
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused gates + pool over head-major tokens xh [b, t, nh, e] -> [b, nh, e].

    attn: stacked gate weights {wa, ba, wb, bb, wc, bc} in the layout of
    `models.abmil.gate_weights` (wa/wb [nh, f, e], the reference's [out, in]).
    """
    b, t, nh, e = xh.shape
    y = xh.reshape(b, t, nh * e)
    bias = mask_bias(mask, b, t, nh, xh.device)
    w = {k: attn[k].to(torch.float32).contiguous() for k in _GATE_KEYS}
    if xh.device.type == "cpu":
        out = gated_attention_pool_plain(y, bias, **w)
    else:
        out = gated_pool_cuda(y, bias, **w)
    return out.reshape(b, nh, e)
