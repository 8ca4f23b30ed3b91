"""Gated attention logits for training: kernel 17 (forward) and 18 (backward), bf16 or f32.

Replaces `madeleine_tpu/ops/gated_logits.py` (`_fwd_kernel`, `_bwd_kernel`,
`gated_logits_train`), the per-op lane's second op (ref: abmil.py:41-52 with
the train-mode Dropout(0.25) on each gate branch, abmil.py:34-39). Per token
row of y [b, t, E] (head-major, E = nh * e) and head h:

    a = drop(tanh(y_h Wa_h^T + ba_h)), g = drop(sigmoid(y_h Wb_h^T + bb_h))
    logits[:, h] = (a g) . wc_h + bc_h                       -> [b, t, nh] f32

with bf16 or f32 operands (f32: the JAX package's Precision.HIGHEST route,
`--precision float32`) and f32 accumulation, activations and logits. Dropout
masks come from `ops/prng.py` (Philox, stream 3 + 2h + branch), the masks of
K6/K7 for the same (seed, row_offset). The backward recomputes the gates
from (y, seed) in f32, as the TPU op does: autograd keeps y and nothing
else. dbc, the sum of the logits' cotangent, is taken outside the kernel
(gated_logits.py:317).

Operands (`encoder_train.train_operands`): wa / wb [nh, f, e] in the
compute dtype, ba / bb / wc [nh, f] and bc [nh] f32. The gate helpers here
also serve K6/K7's plain versions. A CPU tensor takes the plain versions
(any float dtype); a CUDA tensor launches csrc/gated_logits.cu or raises; a
mixed bf16 / f32 operand set raises a ValueError naming the operand. With
f32 operands (`gated_logits_forward_f32`, `gated_logits_backward_f32`) the
forward is the f32 gate product on the FFMA tiles of csrc/gemm_ffma.cuh
(K6 f32's first design, which K6 left for split-TF32 wgmma) and the
backward recomputes the gates there into f32 scratch, runs K7 f32's gate
adjoint over it in place, then both products on the same tiles. In bf16
both kernels run on K6's permuted [Wa; Wb] (`permute_gates`):
the forward forms the gates and their partial logits in one TMA + wgmma
GEMM launch, K6's gate product, and adds the partials in a second; the
backward recomputes the gates and forms their adjoint in one launch of the
same GEMM. Their first designs, the f32 gate products on the mma.sync GEMM
and a separate row pass, stay reachable as `gated_logits_fwd_rowblock_cuda`
and `gated_logits_bwd_rowblock_cuda`, bf16 only, checks that no path
calls.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from madeleine_torch.ops import _build
from madeleine_torch.ops import prng
from madeleine_torch.ops import preattn as pa
from madeleine_torch.ops.preattn import wide

fwd_launches = 0   # kernel 17 launches (one per wrapper call on a bf16 CUDA tensor)
bwd_launches = 0   # kernel 18 launches
fwd_f32_launches = 0   # kernel 17 launches with f32 operands
bwd_f32_launches = 0   # kernel 18 launches with f32 operands
fwd_rowblock_launches = 0   # kernel 17's first design, the check-only entry point
bwd_rowblock_launches = 0   # kernel 18's first design, the check-only entry point

RATE = 0.25  # ref: abmil.py:34-35 (read at call time)

KEYS = ("wa", "ba", "wb", "bb", "wc", "bc")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def gate_masks(seed: int, rows, toks, nh: int, f: int, branch: int, rate: float):
    """Keep-scale masks [b, t, nh, f] of one gate branch of every head."""
    return torch.stack([prng.keep_mask(seed, rows, toks, prng.gate_stream(h, branch), f, rate)
                        for h in range(nh)], dim=2)


def head_mm(yh, w):
    """Per head: yh [b, t, nh, e] . w [nh, f, e]^T -> [b, t, nh, f] (the gate
    products; f32 operands)."""
    return torch.einsum("bthe,hfe->bthf", yh, w)


def gate_dy(dza, dzb, wa, wb):
    """The gates' term of dy per head, dza . wa + dzb . wb: [b, t, nh, f]
    cotangents, [nh, f, e] weights -> [b, t, nh, e] (f32 operands)."""
    return torch.einsum("bthf,hfe->bthe", dza, wa) + torch.einsum("bthf,hfe->bthe", dzb, wb)


def gates_plain(y, w):
    """Pre-dropout gate activations (a_pre, b_pre) [b, t, nh, f] f32 of y
    [b, t, E] (operands exact in their dtype)."""
    b, t, _ = y.shape
    nh, f, e = w["wa"].shape
    yh = wide(y).reshape(b, t, nh, e)
    a_pre = torch.tanh(head_mm(yh, wide(w["wa"])) + w["ba"])
    b_pre = torch.sigmoid(head_mm(yh, wide(w["wb"])) + w["bb"])
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
    dy = gate_dy(dza_c, dzb_c, wide(w["wa"]), wide(w["wb"])).reshape(b, t, nh * e)
    yh = wide(y).reshape(b, t, nh, e)
    grads["wa"] = torch.stack([pa.token_sum(dza_c[:, :, h], yh[:, :, h]) for h in range(nh)])
    grads["wb"] = torch.stack([pa.token_sum(dzb_c[:, :, h], yh[:, :, h]) for h in range(nh)])
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

GATE_CHUNK = 64   # gate columns j per 128-column tile of the gate products


def gate_perm(f: int) -> torch.Tensor:
    """The row order of one head's [Wa; Wb] (2f rows) in the gate products
    of K1, K6 and kernel 18: tile c (128 rows) holds Wa's rows 64 c .. 64 c
    + 63, then Wb's same rows, so that the product's epilogue finds a =
    tanh(.) and g = sigmoid(.) of one column j in one thread
    (csrc/gemm_wgmma.cuh::epilogue_gates, epilogue_gates_bwd). Permuted row
    n comes from row gate_perm(f)[n]."""
    n = torch.arange(2 * f)
    tile, col = n // (2 * GATE_CHUNK), n % (2 * GATE_CHUNK)
    return (col >= GATE_CHUNK) * f + tile * GATE_CHUNK + col % GATE_CHUNK


def permute_gates(w: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(wab [nh, 2f, e], bab [nh, 2f]) in gate_perm's row order, built at the
    kernel boundary on each call as the head-major columns are: the model's
    parameters keep their own layout. wc needs no permutation: the epilogue
    reads it at the column j each tile's rows stand for, in wc's own order."""
    nh, f, e = w["wa"].shape
    c = f // GATE_CHUNK
    wab = torch.stack([w["wa"].reshape(nh, c, GATE_CHUNK, e),
                       w["wb"].reshape(nh, c, GATE_CHUNK, e)], dim=2).reshape(nh, 2 * f, e)
    bab = torch.stack([w["ba"].reshape(nh, c, GATE_CHUNK),
                       w["bb"].reshape(nh, c, GATE_CHUNK)], dim=2).reshape(nh, 2 * f)
    return wab, bab


MATS = ("wa", "wb")


def check_dtypes(y, w, kernel) -> torch.dtype:
    """The call's compute dtype, y's: bf16 or f32, with wa, wb in it and the
    vectors f32. A mixed set raises a ValueError naming the operand."""
    return _build.check_dtypes(kernel, "y", y, w, KEYS, MATS)


def _check(y, w, kernel):
    """(b, t, nh, e, f, compute dtype) after the operand checks: CUDA
    tensors, `check_dtypes`, the widths the kernels take."""
    if y.device.type != "cuda":
        raise ValueError(f"{kernel} kernel needs CUDA tensors, got {y.device}")
    dt = check_dtypes(y, w, kernel)
    b, t, E = y.shape
    nh, f, e = w["wa"].shape
    if E != nh * e or e % 8 or f % 128 or nh * f > 4096 or b < 1 or t < 1:
        raise ValueError(f"{kernel} kernel: unsupported widths E={E}, nh={nh}, e={e}, f={f} "
                         f"(needs E = nh*e, e % 8 == 0, f a multiple of 128, nh*f <= 4096)")
    for k, shape in (("wa", (nh, f, e)), ("ba", (nh, f)), ("wb", (nh, f, e)), ("bb", (nh, f)),
                     ("wc", (nh, f)), ("bc", (nh,))):
        _build.check_operand(kernel, k, w[k], shape, dt if k in MATS else torch.float32,
                             y.device)
    _build.check_operand(kernel, "y", y, (b, t, E), dt, y.device)
    return b, t, nh, e, f, dt


@torch.no_grad()
def gated_logits_fwd_cuda(y, w, seed: int, row_offset: int = 0,
                          rate: float = RATE) -> torch.Tensor:
    """Launch kernel 17 on CUDA tensors, bf16 or f32 (y's dtype); returns as
    `gated_logits_fwd_plain`. Raises where the GEMM refuses an operand."""
    global fwd_launches, fwd_f32_launches
    b, t, nh, e, f, dt = _check(y, w, "gated_logits_fwd")
    _build.check_aligned("gated_logits_fwd", "y", y)
    dev, M = y.device, b * t
    wabp, babp = permute_gates(w)                                  # K6's row order
    logits = torch.empty(b, t, nh, dtype=torch.float32, device=dev)
    lpart = torch.empty(M, nh, f // GATE_CHUNK, dtype=torch.float32, device=dev)
    dims, scales = prng.kernel_args((b, t, nh, e, f), seed, row_offset, rate)
    wide_ = dt == torch.float32
    _build.call_ptrs("gated_logits", "gated_logits_forward_f32" if wide_ else
                     "gated_logits_forward", [y, wabp, babp, w["wc"], w["bc"], logits, lpart],
                     dims, scales, dev)
    if wide_:
        fwd_f32_launches += 1
    else:
        fwd_launches += 1
    return logits


@torch.no_grad()
def gated_logits_fwd_rowblock_cuda(y, w, seed: int, row_offset: int = 0,
                                   rate: float = RATE) -> torch.Tensor:
    """Kernel 17's first design (the f32 gate products on the mma.sync GEMM,
    then a row pass for the dropout and the logits), kept as a check of the
    redesign; no path calls it. bf16 only. Returns as
    `gated_logits_fwd_plain`."""
    global fwd_rowblock_launches
    b, t, nh, e, f, dt = _check(y, w, "gated_logits_fwd_rowblock")
    fn = pa.entry_of({torch.bfloat16: "gated_logits_forward_rowblock"}, dt,
                     "gated_logits_fwd_rowblock")
    dev, M = y.device, b * t
    wab = torch.cat([w["wa"], w["wb"]], dim=1).contiguous()        # [nh, 2f, e]
    bab = torch.cat([w["ba"], w["bb"]], dim=1).contiguous()        # [nh, 2f]
    logits = torch.empty(b, t, nh, dtype=torch.float32, device=dev)
    G = torch.empty(M, 2 * nh * f, dtype=torch.float32, device=dev)
    dims, scales = prng.kernel_args((b, t, nh, e, f), seed, row_offset, rate)
    _build.call_ptrs("gated_logits", fn, [y, wab, bab, w["wc"], w["bc"], logits, G], dims,
                     scales, dev)
    fwd_rowblock_launches += 1
    return logits


def _bwd_outputs(y, dl, w, kernel):
    """Check kernel 18's operands; returns (b, t, nh, e, f, dtype) and the
    outputs dy [b, t, nh e] in y's dtype, dwab [nh, 2f, e], dbab [nh, 2, f],
    dwc [nh, f] f32."""
    b, t, nh, e, f, dt = _check(y, w, kernel)
    _build.check_operand(kernel, "dl", dl, (b, t, nh), torch.float32, y.device)
    _build.check_aligned(kernel, "y", y)
    dev, f32 = y.device, torch.float32
    return (b, t, nh, e, f, dt), [torch.empty(b, t, nh * e, dtype=dt, device=dev),
                                  torch.empty(nh, 2 * f, e, dtype=f32, device=dev),
                                  torch.empty(nh, 2, f, dtype=f32, device=dev),
                                  torch.empty(nh, f, dtype=f32, device=dev)]


def _bwd_grads(outs, dl, f):
    dy, dwab, dbab, dwc = outs
    return {"y": dy, "wa": dwab[:, :f], "wb": dwab[:, f:], "ba": dbab[:, 0], "bb": dbab[:, 1],
            "wc": dwc, "bc": dl.sum((0, 1))}


@torch.no_grad()
def gated_logits_bwd_cuda(y, dl, w, seed: int, row_offset: int = 0,
                          rate: float = RATE) -> Dict[str, torch.Tensor]:
    """Launch kernel 18 on CUDA tensors, bf16 or f32 (y's dtype, dy's too);
    returns as `gated_logits_bwd_plain` (dbc the sum of dl, outside the
    kernel as on the TPU). Raises where the GEMM refuses an operand."""
    global bwd_launches, bwd_f32_launches
    (b, t, nh, e, f, dt), outs = _bwd_outputs(y, dl, w, "gated_logits_bwd")
    dev, M, f32 = y.device, b * t, torch.float32
    wide_ = dt == f32
    dims, scales = prng.kernel_args((b, t, nh, e, f), seed, row_offset, rate)
    ws = _build.workspace("gated_logits", "gated_logits_bwd_workspace_f32" if wide_ else
                          "gated_logits_bwd_workspace", dims)
    wabp, babp = permute_gates(w)                                  # K6's row order
    wab = torch.cat([w["wa"], w["wb"]], dim=1).contiguous()        # [nh, 2f, e]
    # DZG (f32: first the recomputed gates, then DZG in place)
    scratch = [torch.empty(M, 2 * nh * f, dtype=dt, device=dev),
               torch.empty(ws[0], dtype=f32, device=dev),                     # split-K partials
               torch.empty(ws[1], dtype=f32, device=dev)]                     # column partials
    _build.call_ptrs("gated_logits", "gated_logits_backward_f32" if wide_ else
                     "gated_logits_backward", [y, dl, wabp, babp, wab, w["wc"], *outs, *scratch],
                     dims, scales, dev)
    if wide_:
        bwd_f32_launches += 1
    else:
        bwd_launches += 1
    return _bwd_grads(outs, dl, f)


@torch.no_grad()
def gated_logits_bwd_rowblock_cuda(y, dl, w, seed: int, row_offset: int = 0,
                                   rate: float = RATE) -> Dict[str, torch.Tensor]:
    """Kernel 18's first design (the f32 gate products on the mma.sync GEMM,
    then the adjoint pass), kept as a check of the redesign; no path calls
    it. bf16 only. Returns as `gated_logits_bwd_plain`."""
    global bwd_rowblock_launches
    (b, t, nh, e, f, dt), outs = _bwd_outputs(y, dl, w, "gated_logits_bwd_rowblock")
    fn = pa.entry_of({torch.bfloat16: "gated_logits_backward_rowblock"}, dt,
                     "gated_logits_bwd_rowblock")
    dev, M, f32 = y.device, b * t, torch.float32
    dims, scales = prng.kernel_args((b, t, nh, e, f), seed, row_offset, rate)
    ws = _build.workspace("gated_logits", "gated_logits_bwd_rowblock_workspace", dims)
    wab = torch.cat([w["wa"], w["wb"]], dim=1).contiguous()
    bab = torch.cat([w["ba"], w["bb"]], dim=1).contiguous()
    scratch = [torch.empty(M, 2 * nh * f, dtype=f32, device=dev),              # G
               torch.empty(M, 2 * nh * f, dtype=torch.bfloat16, device=dev),   # DZG
               torch.empty(ws[0], dtype=f32, device=dev),                      # split-K partials
               torch.empty(ws[1], dtype=f32, device=dev)]                      # column partials
    _build.call_ptrs("gated_logits", fn, [y, dl, wab, bab, w["wc"], *outs, *scratch],
                     dims, scales, dev)
    bwd_rowblock_launches += 1
    return _bwd_grads(outs, dl, f)


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
