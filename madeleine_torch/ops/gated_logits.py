"""Gated attention logits for training: kernel 17 (forward) and 18 (backward), bf16.

Replaces `madeleine_tpu/ops/gated_logits.py` (`_fwd_kernel`, `_bwd_kernel`,
`gated_logits_train`), the per-op lane's second op (ref: abmil.py:41-52 with
the train-mode Dropout(0.25) on each gate branch, abmil.py:34-39). Per token
row of y [b, t, E] (head-major, E = nh * e) and head h:

    a = drop(tanh(y_h Wa_h^T + ba_h)), g = drop(sigmoid(y_h Wb_h^T + bb_h))
    logits[:, h] = (a g) . wc_h + bc_h                       -> [b, t, nh] f32

with bf16 operands and f32 accumulation, activations and logits. Dropout
masks come from `ops/prng.py` (Philox, stream 3 + 2h + branch), the masks of
K6/K7 for the same (seed, row_offset). The backward recomputes the gates
from (y, seed) in f32, as the TPU op does: autograd keeps y and nothing
else. dbc, the sum of the logits' cotangent, is taken outside the kernel
(gated_logits.py:317).

Operands (`encoder_train.train_operands`): wa / wb [nh, f, e] in the
compute dtype, ba / bb / wc [nh, f] and bc [nh] f32. The gate helpers here
also serve K6/K7's plain versions. A CPU tensor takes the plain versions
(any float dtype); a CUDA tensor launches csrc/gated_logits.cu, bf16 only,
or raises.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from madeleine_torch.ops import _build
from madeleine_torch.ops import prng
from madeleine_torch.ops.preattn import F32_TODO, wide

fwd_launches = 0   # kernel 17 launches (one per wrapper call on a CUDA tensor)
bwd_launches = 0   # kernel 18 launches

RATE = 0.25  # ref: abmil.py:34-35 (read at call time)

KEYS = ("wa", "ba", "wb", "bb", "wc", "bc")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def gate_masks(seed: int, rows, toks, nh: int, f: int, branch: int, rate: float):
    """Keep-scale masks [b, t, nh, f] of one gate branch of every head."""
    return torch.stack([prng.keep_mask(seed, rows, toks, prng.gate_stream(h, branch), f, rate)
                        for h in range(nh)], dim=2)


def gates_plain(y, w):
    """Pre-dropout gate activations (a_pre, b_pre) [b, t, nh, f] f32 of y
    [b, t, E] (operands exact in their dtype)."""
    b, t, _ = y.shape
    nh, f, e = w["wa"].shape
    yh = wide(y).reshape(b, t, nh, e)
    a_pre = torch.tanh(torch.einsum("bthe,hfe->bthf", yh, wide(w["wa"])) + w["ba"])
    b_pre = torch.sigmoid(torch.einsum("bthe,hfe->bthf", yh, wide(w["wb"])) + w["bb"])
    return a_pre, b_pre


def logits_plain(a_pre, b_pre, ma, mb, w):
    """Raw logits [b, t, nh] f32 from the gate activations and masks."""
    return ((a_pre * ma) * (b_pre * mb) * w["wc"]).sum(-1) + w["bc"]


def gates_bwd_plain(ap, bp, ma, mb, dl, y, w):
    """The adjoint of the gates and logits (gated_logits.py::_bwd_kernel) at
    the activations ap, bp (f32 values) for the logits' cotangent dl
    [b, t, nh] f32. Returns (dy [b, t, E] f32, {wa, ba, wb, bb, wc}: f32)."""
    dt = y.dtype
    b, t, _ = y.shape
    nh, f, e = w["wa"].shape
    a, bv = ap * ma, bp * mb
    dl4 = dl[..., None]
    grads = {"wc": ((a * bv) * dl4).sum((0, 1))}
    dg = dl4 * w["wc"]
    dza = dg * bv * ma * (1.0 - ap * ap)
    dzb = dg * a * mb * bp * (1.0 - bp)
    dza_c, dzb_c = wide(dza.to(dt)), wide(dzb.to(dt))
    dy = (torch.einsum("bthf,hfe->bthe", dza_c, wide(w["wa"]))
          + torch.einsum("bthf,hfe->bthe", dzb_c, wide(w["wb"]))).reshape(b, t, nh * e)
    yh = wide(y).reshape(b, t, nh, e)
    grads["wa"] = torch.einsum("bthf,bthe->hfe", dza_c, yh)
    grads["wb"] = torch.einsum("bthf,bthe->hfe", dzb_c, yh)
    grads["ba"] = dza.sum((0, 1))
    grads["bb"] = dzb.sum((0, 1))
    return dy, grads


def _masks(y, w, seed, row_offset, rate):
    nh, f, _ = w["wa"].shape
    rows, toks = prng.site_rows(y.shape[0], y.shape[1], row_offset, y.device)
    return (gate_masks(seed, rows, toks, nh, f, 0, rate),
            gate_masks(seed, rows, toks, nh, f, 1, rate))


def gated_logits_fwd_plain(y, w, seed: int, row_offset: int = 0,
                           rate: float = RATE) -> torch.Tensor:
    """y [b, t, E] -> logits [b, t, nh] f32."""
    return logits_plain(*gates_plain(y, w), *_masks(y, w, seed, row_offset, rate), w)


@torch.no_grad()
def gated_logits_bwd_plain(y, dl, w, seed: int, row_offset: int = 0,
                           rate: float = RATE) -> Dict[str, torch.Tensor]:
    """The adjoint of `gated_logits_fwd_plain` for the cotangent dl [b, t, nh]
    f32, recomputing the gates as kernel 18 does. Returns {"y": dy in
    y.dtype, key of KEYS: f32 gradient}."""
    dy, grads = gates_bwd_plain(*gates_plain(y, w), *_masks(y, w, seed, row_offset, rate),
                                dl, y, w)
    grads["y"] = dy.to(y.dtype)
    grads["bc"] = dl.sum((0, 1))
    return grads


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

def _check(y, w, kernel):
    if y.device.type != "cuda":
        raise ValueError(f"{kernel} kernel needs CUDA tensors, got {y.device}")
    if y.dtype != torch.bfloat16:
        raise NotImplementedError(f"{kernel} kernel runs in bf16 only, got {y.dtype} "
                                  f"({F32_TODO})")
    b, t, E = y.shape
    nh, f, e = w["wa"].shape
    if E != nh * e or e % 8 or f % 128 or nh * f > 4096 or b < 1 or t < 1:
        raise ValueError(f"{kernel} kernel: unsupported widths E={E}, nh={nh}, e={e}, f={f} "
                         f"(needs E = nh*e, e % 8 == 0, f a multiple of 128, nh*f <= 4096)")
    for k, shape in (("wa", (nh, f, e)), ("ba", (nh, f)), ("wb", (nh, f, e)), ("bb", (nh, f)),
                     ("wc", (nh, f)), ("bc", (nh,))):
        _build.check_operand(kernel, k, w[k], shape,
                             torch.bfloat16 if k in ("wa", "wb") else torch.float32, y.device)
    _build.check_operand(kernel, "y", y, (b, t, E), torch.bfloat16, y.device)
    return b, t, nh, e, f


@torch.no_grad()
def gated_logits_fwd_cuda(y, w, seed: int, row_offset: int = 0,
                          rate: float = RATE) -> torch.Tensor:
    """Launch kernel 17 on CUDA tensors; returns as `gated_logits_fwd_plain`."""
    global fwd_launches
    b, t, nh, e, f = _check(y, w, "gated_logits_fwd")
    dev, M = y.device, b * t
    wab = torch.cat([w["wa"], w["wb"]], dim=1).contiguous()        # [nh, 2f, e]
    bab = torch.cat([w["ba"], w["bb"]], dim=1).contiguous()        # [nh, 2f]
    logits = torch.empty(b, t, nh, dtype=torch.float32, device=dev)
    G = torch.empty(M, 2 * nh * f, dtype=torch.float32, device=dev)
    dims, scales = prng.kernel_args((b, t, nh, e, f), seed, row_offset, rate)
    _build.call_ptrs("gated_logits", "gated_logits_forward",
                     [y, wab, bab, w["wc"], w["bc"], logits, G], dims, scales, dev)
    fwd_launches += 1
    return logits


@torch.no_grad()
def gated_logits_bwd_cuda(y, dl, w, seed: int, row_offset: int = 0,
                          rate: float = RATE) -> Dict[str, torch.Tensor]:
    """Launch kernel 18 on CUDA tensors; returns as `gated_logits_bwd_plain`
    (dbc the sum of dl, outside the kernel as on the TPU)."""
    global bwd_launches
    b, t, nh, e, f = _check(y, w, "gated_logits_bwd")
    _build.check_operand("gated_logits_bwd", "dl", dl, (b, t, nh), torch.float32, y.device)
    dev, M, f32 = y.device, b * t, torch.float32
    dims, scales = prng.kernel_args((b, t, nh, e, f), seed, row_offset, rate)
    ws = _build.workspace("gated_logits", "gated_logits_bwd_workspace", dims)
    wab = torch.cat([w["wa"], w["wb"]], dim=1).contiguous()
    bab = torch.cat([w["ba"], w["bb"]], dim=1).contiguous()
    dy = torch.empty(b, t, nh * e, dtype=torch.bfloat16, device=dev)
    dwab = torch.empty(nh, 2 * f, e, dtype=f32, device=dev)
    dbab = torch.empty(nh, 2, f, dtype=f32, device=dev)
    dwc = torch.empty(nh, f, dtype=f32, device=dev)
    scratch = [torch.empty(M, 2 * nh * f, dtype=f32, device=dev),              # G
               torch.empty(M, 2 * nh * f, dtype=torch.bfloat16, device=dev),   # DZG
               torch.empty(ws[0], dtype=f32, device=dev),                      # split-K partials
               torch.empty(ws[1], dtype=f32, device=dev)]                      # column partials
    _build.call_ptrs("gated_logits", "gated_logits_backward",
                     [y, dl, wab, bab, w["wc"], dy, dwab, dbab, dwc, *scratch],
                     dims, scales, dev)
    bwd_launches += 1
    return {"y": dy, "wa": dwab[:, :f], "wb": dwab[:, f:], "ba": dbab[:, 0], "bb": dbab[:, 1],
            "wc": dwc, "bc": dl.sum((0, 1))}


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

class GatedLogitsTrain(torch.autograd.Function):
    """(y, seed, row_offset, rate, *operands in KEYS order) -> raw logits
    [b, t, nh] f32."""

    @staticmethod
    def forward(ctx, y, seed, row_offset, rate, *ws):
        w = dict(zip(KEYS, ws))
        fwd = gated_logits_fwd_cuda if y.is_cuda else gated_logits_fwd_plain
        logits = fwd(y, w, seed, row_offset, rate)
        ctx.args = (seed, row_offset, rate)
        ctx.save_for_backward(y, *ws)
        return logits

    @staticmethod
    def backward(ctx, dl):
        y, *ws = ctx.saved_tensors
        w = dict(zip(KEYS, ws))
        bwd = gated_logits_bwd_cuda if y.is_cuda else gated_logits_bwd_plain
        grads = bwd(y, wide(dl).contiguous(), w, *ctx.args)
        return (grads["y"], None, None, None) + tuple(grads[k].to(w[k].dtype) for k in KEYS)


def gated_logits_train(y: torch.Tensor, w: Dict[str, torch.Tensor], seed: int,
                       row_offset: int = 0, rate: Optional[float] = None) -> torch.Tensor:
    """Training-mode gated attention logits with their dropout (JAX
    `gated_logits_train`). y [b, t, E] head-major in the compute dtype, w:
    the operands (`encoder_train.train_operands`), seed: int, row_offset:
    the global batch row of y's first row, rate: None reads RATE at call
    time. Returns raw logits [b, t, nh] f32."""
    rate = RATE if rate is None else rate
    return GatedLogitsTrain.apply(y.contiguous(), int(seed), int(row_offset), float(rate),
                                  *(w[k] for k in KEYS))
