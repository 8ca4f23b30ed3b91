"""Fused gated-attention scoring + softmax pooling (kernel K2, f32).

Replaces `madeleine_tpu/ops/gated_pool.py::_gated_pool_kernel`. After the
pre-attention MLP, per head h:

    l_h    = (tanh(y_h Wa_h^T + ba_h) * sigmoid(y_h Wb_h^T + bb_h)) . wc_h + bc_h
    pooled = sum_t softmax_t(l_h + mask_bias)[t] * y_h[t]

all f32-accurate (the parity route: Precision.HIGHEST on the TPU). On the
card the gate products are three TF32 tensor-core products of a hi/lo split
of each operand (`split_tf32`; csrc/gated_pool.cu, csrc/wgmma_tf32.cuh): the
weights' halves are built once per weight state (`split_operands`, kept by
`models.abmil.kernel_operands`), y's in shared memory as each tile lands. A
CPU tensor takes the plain PyTorch version; a CUDA tensor launches the kernel
or raises. The first design (plain FP32 FMA) stays reachable as
`gated_pool_ffma_cuda`, a check that no path calls.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from madeleine_torch.ops import _build
from madeleine_torch.ops.attn_pool import mask_bias, softmax_pool_plain
from madeleine_torch.ops.gated_logits import permute_gates

launches = 0        # kernel launches (one per wrapper call on a CUDA tensor)
ffma_launches = 0   # launches of the first design, the check-only entry point

TILE_ROWS = 128     # tokens per tile of the kernel's softmax partials (csrc/gated_pool.cu k2::TM)
K_TILE = 32         # f32 k per stage: e must be a multiple
GATE_CHUNK = 64     # gate columns per chunk: f must be a multiple

_GATE_KEYS = ("wa", "ba", "wb", "bb", "wc", "bc")
_SPLIT_KEYS = ("wab_hi", "wab_lo", "bab", "wc", "bc")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x (f32) rounded to TF32 as `cvt.rna.tf32.f32` does: to the nearest
    value whose low 13 mantissa bits are zero, ties away from zero (half of
    the dropped bits' unit added to the magnitude, then the bits cleared)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """(hi, lo): hi = tf32(x), lo = tf32(x - hi), so hi + lo = x within
    2^-22 |x| and a product of two split operands keeps about 21 bits."""
    hi = round_tf32(x)
    return hi, round_tf32(x.to(torch.float32) - hi)


@torch.no_grad()
def split_gates(wab: torch.Tensor) -> Dict[str, torch.Tensor]:
    """{"wab_hi", "wab_lo"} of the permuted gate weights wab [nh, 2f, e]
    (`gated_logits.permute_gates`' order): the kernel's weight operands."""
    hi, lo = split_tf32(wab)
    return {"wab_hi": hi.contiguous(), "wab_lo": lo.contiguous()}


@torch.no_grad()
def split_operands(wa, ba, wb, bb, wc, bc) -> Dict[str, torch.Tensor]:
    """The kernel's weight operands {wab_hi, wab_lo, bab, wc, bc} (f32)
    built from the stacked gate weights: the split of the permuted
    [Wa; Wb], the permuted [ba; bb], and wc, bc as they are."""
    wab, bab = permute_gates({"wa": wa.float(), "ba": ba.float(), "wb": wb.float(),
                              "bb": bb.float()})
    return dict(split_gates(wab), bab=bab.contiguous(), wc=wc.float().contiguous(),
                bc=bc.float().contiguous())


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


def _check(kernel, y, bias, w, k_tile, nh, f, e):
    """(b, t) after the operand checks of either design: w holds the
    design's own weight operands, sized by nh heads, f gate columns and e
    per-head width."""
    if y.device.type != "cuda":
        raise ValueError(f"{kernel} kernel needs CUDA tensors, got {y.device}")
    b, t, E = y.shape
    if E != nh * e or e % k_tile or f % GATE_CHUNK or t < 1 or b < 1:
        raise ValueError(f"{kernel} kernel: unsupported shape y {tuple(y.shape)} with "
                         f"{nh} heads of {e} and {f} gate columns (needs e % {k_tile} == 0, "
                         f"f % {GATE_CHUNK} == 0)")
    shapes = {"y": (b, t, E), "bias": (b, t, nh), "wa": (nh, f, e), "ba": (nh, f),
              "wb": (nh, f, e), "bb": (nh, f), "wc": (nh, f), "bc": (nh,),
              "wab_hi": (nh, 2 * f, e), "wab_lo": (nh, 2 * f, e), "bab": (nh, 2 * f)}
    for name, x in dict(w, y=y, bias=bias).items():
        _build.check_operand(kernel, name, x, shapes[name], torch.float32, y.device)
    return b, t


@torch.no_grad()
def gated_pool_cuda(y, bias, wab_hi, wab_lo, bab, wc, bc) -> torch.Tensor:
    """Launch kernel K2 on CUDA tensors: y [b, t, nh*e] and bias [b, t, nh]
    as the plain version takes them, and the weights' `split_operands`
    (wab_hi, wab_lo [nh, 2f, e], bab [nh, 2f], wc [nh, f], bc [nh]), built
    once per weight state by the caller."""
    global launches
    w = {"wab_hi": wab_hi, "wab_lo": wab_lo, "bab": bab, "wc": wc, "bc": bc}
    nh, f, e = wab_hi.shape[0], wab_hi.shape[1] // 2, wab_hi.shape[2]
    b, t = _check("gated_pool", y, bias, w, K_TILE, nh, f, e)
    for name, x in (("y", y), ("wab_hi", wab_hi), ("wab_lo", wab_lo)):
        _build.check_aligned("gated_pool", name, x)
    out = _build.launch_split_pool("gated_pool", [y, bias, wab_hi, wab_lo, bab, wc, bc],
                                   (b, t, nh, e, f), b, t, nh, nh * e, torch.float32)
    launches += 1
    return out


@torch.no_grad()
def gated_pool_ffma_cuda(y, bias, wa, ba, wb, bb, wc, bc) -> torch.Tensor:
    """K2's first design (the gate products in FP32 FMA, 64-token tiles),
    kept as a check on the card beside `gated_pool_cuda`; no path of the
    port calls it. Arguments as the plain version."""
    global ffma_launches
    w = {"wa": wa, "ba": ba, "wb": wb, "bb": bb, "wc": wc, "bc": bc}
    nh, f, e = wa.shape
    b, t = _check("gated_pool_ffma", y, bias, w, 16, nh, f, e)
    out = _build.launch_split_pool("gated_pool", [y, bias, *(w[k] for k in _GATE_KEYS)],
                                   (b, t, nh, e, f), b, t, nh, nh * e, torch.float32,
                                   prefix="gated_pool_ffma")
    ffma_launches += 1
    return out


@torch.no_grad()
def gated_attention_pool(attn: Dict[str, torch.Tensor], xh: torch.Tensor,
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused gates + pool over head-major tokens xh [b, t, nh, e] -> [b, nh, e].

    attn: the stacked gate weights {wa, ba, wb, bb, wc, bc} in the layout of
    `models.abmil.gate_weights` (wa/wb [nh, f, e], the reference's [out, in]),
    or the kernel's operands {wab_hi, wab_lo, bab, wc, bc} built from them
    once per weight state (`split_operands`, as `models.abmil.kernel_operands`
    keeps them in f32). A CPU tensor takes the plain version on the stacked
    weights; a CUDA one launches the kernel on the operands, split here for
    this call where the caller holds none.
    """
    b, t, nh, e = xh.shape
    y = xh.reshape(b, t, nh * e)
    bias = mask_bias(mask, b, t, nh, xh.device)
    if xh.device.type == "cpu":
        w = {k: attn[k].to(torch.float32).contiguous() for k in _GATE_KEYS}
        out = gated_attention_pool_plain(y, bias, **w)
    else:
        ops = ({k: attn[k] for k in _SPLIT_KEYS} if "wab_hi" in attn
               else split_operands(**{k: attn[k] for k in _GATE_KEYS}))
        out = gated_pool_cuda(y, bias, **ops)
    return out.reshape(b, nh, e)
