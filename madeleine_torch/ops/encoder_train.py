"""Whole-encoder training op: kernel K6 (forward) and K7 (backward), bf16 or f32.

Replaces `madeleine_tpu/ops/encoder_train.py` (`_fwd_kernel`, `_bwd_kernel`,
both save_acts routes, n_views 1 and 3, need_dx off and on). Per token row of x:

    3 x [Linear -> LayerNorm -> GELU (exact erf) -> dropout(pre_rate)] -> y32
    tok = y Wt^T + bt
    per head: a = drop(tanh(y_h Wa_h^T + ba)), g = drop(sigmoid(y_h Wb_h^T + bb)),
              l_h = (a g) . wc_h + bc_h + mask bias
    pooled = per-head softmax pool of y32 over the bag's tokens
    with a half_mask [t] (n_views=3, the intra-modality loss): also over
    half 1 (half_mask) and half 2 (~half_mask), re-softmaxing the same
    logits plus a view bias [t, 2] (0 inside the view, NEG_INF outside,
    shared by every bag: `_view_bias`, encoder_train.py:611-617)

with bf16 operands, f32 accumulation and f32 bias / LN / GELU; each layer's
output is rounded to bf16 before the next product, the pool sums f32 y32.
On the save route the forward saves u1, u2, u3 (normalised LN inputs),
a_pre, b_pre (bf16) and the three LN rstd (f32), and the backward rebuilds
every activation from them elementwise. On the recompute route (save_acts
off, JAX's `_recompute_stack`, encoder_train.py:128-141) the forward keeps
none of them and the backward first recomputes them from (x, seed) with
the forward's own code (K6's device code inside K7 on the card, one
function in the plain versions), so both routes give the same gradients
bit for bit. `resolve_save_acts` picks the route as JAX's
`_resolve_save_acts` does (:84-115): a budget of ACT_BUDGET_BYTES for the
call's saves, and on the card a guard that counts the memory left. With views it
gives (pooled, m, s) per view, and the backward sums the views' terms into
the cotangent of y and of the logits (encoder_train.py:341-356, 651-659). A
view with no unmasked token (possible only with a token mask, or t = 1)
pools to 0 (the plain pool's rule; the TPU kernel pools it near-uniformly,
encoder_train.py:231-236). With need_dx (the
input carries the learned stain-encoding columns) the backward also emits
dx = dz1 . W1, the input gradient, in x's dtype. Dropout masks come from
`ops/prng.py` (Philox, keyed by site), identical in both directions and in
the plain and CUDA versions.

Operands are head-major (`train_operands`): w1 [h, d_in], w2 [h, h],
w3 [E, h] ([out, in] layout), biases b*, LN scales s* and shifts t*,
wa / wb [nh, f, e], ba / bb / wc [nh, f], bc [nh], wt [d_out, E], bt [d_out];
matrices in the compute dtype, vectors in f32.

A CPU tensor takes the plain PyTorch versions (any float dtype, for the
parity tests); a CUDA tensor launches K6 / K7 from csrc/encoder_train_fwd.cu
and csrc/encoder_train_bwd.cu, or raises. In bf16 both run every product on
the TMA + wgmma GEMM of csrc/gemm_wgmma.cuh; K6 forms the gate logits in its
gate product's epilogue, for which the wrapper hands it [Wa; Wb] and [ba;
bb] with their rows permuted (`permute_gates`). With f32 operands (the JAX
package's parity route, `--precision float32`) the same launch sequences
take every operand, residual, token and cotangent in f32, nothing rounded
between layers, exact tanh and sigmoid, every product on the split-TF32
TMA + wgmma GEMM of csrc/gemm_tf32.cuh: each operand cut into TF32 hi and
lo (`gated_pool.split_tf32`; the weights once a call, into the workspace
the wrappers allocate), each 32-deep k tile a fresh partial of lo.hi +
hi.lo + hi.hi added to the running sum in k order; the weight gradients'
token sums in pieces of whole k tiles summed in piece order
(`tf32_wgrad_chunk`), the gate logits' 64-column partials each four
threads' 16-column sums added in xor order. The per-op kernels 15-18 with
f32 operands keep the first design's FFMA tiles (csrc/gemm_ffma.cuh,
`ffma_wgrad_chunk`).

A call whose transient buffers would not fit runs in blocks of whole bags
(`encoder_blocks`, chosen on the host before any launch from the shapes,
the dtype and the card's total memory, never its free memory, since the
blocks set the weight gradients' sum order): each block is one
K6 / K7 call on x[b0:b1] at row offset row_offset + b0, so it draws the
unblocked call's dropout masks; the forward's outputs and dx are the
unblocked call's bit for bit, and the backward sums each block's f32 weight
gradients in block order.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from madeleine_torch.ops import _build
from madeleine_torch.ops import gated_logits as gl
from madeleine_torch.ops.gated_logits import (GATE_CHUNK, gate_perm,  # noqa: F401
                                              permute_gates)
from madeleine_torch.ops import preattn as pa
from madeleine_torch.ops import prng
from madeleine_torch.ops.attn_pool import MASKED_BIAS, NEG_INF, mask_bias
from madeleine_torch.ops.linear_tok import linear_tok_fwd_plain, tok_bwd_plain

fwd_launches = 0   # K6 launches in bf16 (one per wrapper call on a CUDA tensor)
bwd_launches = 0   # K7 launches in bf16
fwd_nosave_launches = 0    # of K6's bf16 launches, those that kept no residuals
bwd_recompute_launches = 0   # of K7's bf16 launches, those on the recompute route (B1c)
fwd_f32_launches = 0   # K6 launches with f32 operands
bwd_f32_launches = 0   # K7 launches with f32 operands
fwd_f32_nosave_launches = 0    # of K6's f32 launches, those that kept no residuals
bwd_f32_recompute_launches = 0   # of K7's f32 launches, those on the recompute route
# calls of the op run in more than one block of whole bags (either dtype, any
# device), and the blocks those calls had: the forward's and the backward's
fwd_blocked_calls = 0
fwd_blocks = 0
bwd_blocked_calls = 0
bwd_blocks = 0

PRE_RATE = pa.RATE     # ref: Model.py:354,358,362 (read at call time)
GATE_RATE = gl.RATE    # ref: abmil.py:34-35

W_KEYS = ("w1", "b1", "s1", "t1", "w2", "b2", "s2", "t2", "w3", "b3", "s3", "t3",
          "wa", "ba", "wb", "bb", "wc", "bc", "wt", "bt")
MATS = ("w1", "w2", "w3", "wa", "wb", "wt")
SAVED = ("u1", "u2", "u3", "ap", "bp", "rstd")

# The saves of one call (u1 u2 u3 a_pre b_pre, rstd) may take this many
# bytes on the save route (JAX encoder_train.py:66-67, read at import, as
# there); past it the call takes the recompute route. 10 GiB by default.
ACT_BUDGET_BYTES = int(os.environ.get("MADELEINE_ENCODER_ACT_BUDGET", str(10 * 1024 ** 3)))
NO_SAVE_VAR = "MADELEINE_ENCODER_NO_SAVE_ACTS"   # any non-empty value: always recompute
GUARD_MARGIN = 2 * 1024 ** 3
# The transient bytes one K6 or K7 call (one block of whole bags) may take:
# 48 GiB keeps every call of the published steps one block, the recompute
# route's [65, 16384] in bf16 (47.3 GB reckoned by `_block_row_bytes`) and
# [65, 8192] in f32 (41.7 GB) included; [65, 32768] in bf16 (94.7 GB) and
# [65, 16384] in f32 (83.3 GB) run in two blocks.
BLOCK_BUDGET_BYTES = 48 * 1024 ** 3
# On the card a block's buffers must also fit the card's total memory
# (`device_total_bytes`) less this margin. The save gate keeps 2 GiB
# (GUARD_MARGIN) for what outlives its call; a block's buffers die with it,
# so its margin covers the allocator's rounding and the call's small buffers
# beside the reckoned ones. At 80 GB the total less the margin is past the
# budget, so there the budget alone sets the blocks.
BLOCK_MARGIN = 1024 ** 3
# The most rows (b t) one call of the kernels takes: K6 / K7 count rows in a
# 32-bit int and round them up to a tile of at most 256 rows
# (csrc/train_common.cuh::MAX_TRAIN_ROWS), the TMA maps of the bf16
# products need extents below 2**31; the per-op kernels 15-18's f32 tile
# grid (csrc/gemm_ffma.cuh::launch) has at most 65535 row tiles of 128, a
# limit K6 / K7 with f32 operands (persistent, csrc/gemm_tf32.cuh) keep so
# that the two lanes share one rule. Every
# offset into a buffer of the call is 64-bit, so within these any block
# the rule allows is addressed correctly. The per-op lane's kernels (rows
# 4-5, 15-20) take the same row limits, and rows 4-5 at most 65535 bags a
# call (their grid's y and z extents): MAX_POOL_BAGS.
MAX_POOL_BAGS = 65535
MAX_BLOCK_ROWS = {torch.bfloat16: 2 ** 31 - 256, torch.float32: 65535 * 128}

# The f32 weight gradients' token pieces: the token sum of an [Mo, No]
# gradient x batches split into pieces so that the launch offers about
# FFMA_SPLIT_BLOCKS 128 x 128 tiles, each piece at least FFMA_SPLIT_MIN
# tokens, a whole number of stages: TF32_KTILE-token k tiles for K6 / K7
# (csrc/gemm_tf32.cuh::wgrad_chunk), FFMA_STAGE-token stages for the per-op
# kernels 15-18 (csrc/gemm_ffma.cuh::wgrad_chunk).
FFMA_SPLIT_BLOCKS = 264
FFMA_SPLIT_MIN = 1024
FFMA_STAGE = 16
FFMA_TILE = 128
TF32_KTILE = 32


def _device_hbm_limit(device=None) -> Optional[int]:
    """The bytes a call's saves may still take on the card: the free bytes
    (`torch.cuda.mem_get_info`) plus the caching allocator's reserved but
    unallocated ones; None on the CPU (no limit, as in JAX). JAX's guard
    reads the card's whole limit because its modality scan keeps one
    stain's saves alive at a time; the port keeps every earlier stain's
    until the backward, so the guard counts what is already allocated. Host
    reads of the allocator's counters, not of the card's data: no sync."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    return int(free + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device))


def device_total_bytes(device=None) -> Optional[int]:
    """The card's whole memory (`torch.cuda.get_device_properties(...)
    .total_memory`), None on the CPU: the fixed limit the block rule reads,
    as JAX's guard reads the device's `bytes_limit`. Never the free bytes: a
    call's blocks set the order in which its weight gradients are summed, so
    they must not move with whatever else is live on the card (ROADMAP.md
    C1). A host read of the device's properties: no sync."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return None
    return int(torch.cuda.get_device_properties(device).total_memory)


def resolve_save_acts(save_acts: Optional[bool], b: int, t: int, h: int, E: int, nhf2: int,
                      itemsize: int, x_bytes: int = 0, device=None) -> bool:
    """The route of one call, by JAX's `_resolve_save_acts`
    (encoder_train.py:84-115): False whenever MADELEINE_ENCODER_NO_SAVE_ACTS
    is set, else an explicit save_acts; else True when the saves, b t ((2 h
    + E + nhf2) itemsize + 12) bytes, fit ACT_BUDGET_BYTES and, where the
    device has a limit (`_device_hbm_limit`), the saves plus 4 x_bytes fit
    under it less 2 GiB. Reading the free memory is safe here, unlike in the
    block rule: the two routes give the same gradients bit for bit (K7's
    recompute route re-runs K6's own code), so the route a call takes never
    changes its numbers."""
    if os.environ.get(NO_SAVE_VAR):
        return False
    if save_acts is not None:
        return bool(save_acts)
    saved = b * t * ((2 * h + E + nhf2) * itemsize + 3 * 4)
    if saved > ACT_BUDGET_BYTES:
        return False
    limit = _device_hbm_limit(device)
    if limit:
        return saved + 4 * x_bytes <= limit - GUARD_MARGIN
    return True


def _wgrad_chunk(Mo: int, No: int, tokens: int, batches: int, stage: int) -> int:
    def cdiv(a, b):
        return -(-a // b)

    tiles = cdiv(Mo, FFMA_TILE) * cdiv(No, FFMA_TILE) * batches
    s = max(1, min(cdiv(FFMA_SPLIT_BLOCKS, tiles), cdiv(tokens, FFMA_SPLIT_MIN)))
    return cdiv(cdiv(tokens, s), stage) * stage


def ffma_wgrad_chunk(Mo: int, No: int, tokens: int, batches: int) -> int:
    """The piece length (tokens) of a weight gradient's split token sum on the
    per-op kernels 15-18 with f32 operands; the pieces' partials are summed
    in piece order."""
    return _wgrad_chunk(Mo, No, tokens, batches, FFMA_STAGE)


def tf32_wgrad_chunk(Mo: int, No: int, tokens: int, batches: int) -> int:
    """The piece length (tokens) of a weight gradient's split token sum on K6
    / K7 with f32 operands: whole 32-token k tiles; the pieces' partials are
    summed in piece order."""
    return _wgrad_chunk(Mo, No, tokens, batches, TF32_KTILE)


def _block_row_bytes(widths: Sequence[int], itemsize: int, recompute: bool,
                     need_dx: bool = False, n_views: int = 1) -> int:
    """Transient bytes per row (token) of the larger of one K6 and one K7
    call, from the buffers their wrappers allocate; widths = (d_in, hidden,
    nh, e, f, d_out), itemsize that of the compute dtype. K6: the f32
    scratch Z, H1, H2, Y (bf16 only), the logit and pool partials, and the
    block's outputs (tokens, logits; the saves on the save route) until
    they are copied into the call's. K7: H1, H2, Y, DY, DL, DZG, DZ3, DH,
    DZ12, the column partials, dx with need_dx, and the rebuilt saves on
    the recompute route. The split-K partials and, with f32 operands, the
    weights split into TF32 hi and lo (about 31 MB for K6, 60 MB for K7 at
    the published widths) do not grow with the rows: BLOCK_MARGIN covers
    them."""
    d_in, hd, nh, e, f, dout = widths
    q, E, nhf = itemsize, nh * e, nh * f
    saves = (2 * hd + E + 2 * nhf) * q + 3 * 4
    k6 = (4 * max(hd, E) + 2 * hd * q + (E * q if q < 4 else 0) + nhf // 64 * 4
          + n_views * (E + 2 * nh) * 4 // 64 + dout * q + nh * 4 + (0 if recompute else saves))
    colpart = max(3 * nhf, 3 * E, 3 * hd, dout, nh) * 4 // 64
    k7 = (2 * hd * q + E * q + 4 * E + 4 * nh + 2 * nhf * q + E * q + 4 * hd + hd * q
          + colpart + (d_in * q if need_dx else 0) + (saves if recompute else 0))
    return max(k6, k7)


def whole_bag_blocks(b: int, t: int, row_bytes: int, max_rows: int, limit: Optional[int] = None,
                     budget: int = BLOCK_BUDGET_BYTES, max_bags: Optional[int] = None,
                     what: str = "encoder_train") -> List[Tuple[int, int]]:
    """The blocks of whole bags [(b0, b1), ...] that a call over b bags of t
    rows runs in, `row_bytes` transient bytes a row: contiguous, covering
    [0, b), as few as keep each block's bytes under `budget` and, where
    given, under `limit` (the card's total memory, `device_total_bytes`)
    less BLOCK_MARGIN, its rows under `max_rows` and its bags under
    `max_bags`; then of equal size, the last one shorter when they do not
    divide b. Host arithmetic on shapes: no sync, and the same blocks
    whatever else is live on the card. Raises MemoryError when one bag
    alone does not fit."""
    per_bag = t * row_bytes
    cap = budget if limit is None else min(budget, limit - BLOCK_MARGIN)
    bags = min(cap // per_bag, max_rows // t)
    if max_bags is not None:
        bags = min(bags, max_bags)
    if bags < 1:
        raise MemoryError(f"{what}: one bag of {t} tokens needs {per_bag} transient "
                          f"bytes, past the {cap} a block may take (or past {max_rows} rows)")
    n = -(-b // bags)
    size = -(-b // n)
    return [(b0, min(b0 + size, b)) for b0 in range(0, b, size)]


def encoder_blocks(b: int, t: int, widths: Sequence[int], dtype: torch.dtype, recompute: bool,
                   limit: Optional[int] = None, need_dx: bool = False,
                   n_views: int = 1) -> List[Tuple[int, int]]:
    """The blocks of whole bags of one call of the op (`whole_bag_blocks`):
    each block's transient bytes (`_block_row_bytes` times its rows) under
    BLOCK_BUDGET_BYTES and, where the device has a limit (the caller passes
    `device_total_bytes`), under that limit less BLOCK_MARGIN, and its rows
    under MAX_BLOCK_ROWS. Raises MemoryError when one bag alone does not
    fit."""
    row = _block_row_bytes(widths, torch.empty((), dtype=dtype).element_size(), recompute,
                           need_dx, n_views)
    return whole_bag_blocks(b, t, row, MAX_BLOCK_ROWS.get(dtype, 2 ** 31 - 256), limit)


def train_operands(w: Dict[str, torch.Tensor], dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The op's operand types from head-major tensors (kept in the autograd
    graph): every tensor rounded to `dtype` (the compute-dtype copy of the
    f32 master weights), then vectors widened to f32, as the JAX package's
    _weight_args does after its parameter cast."""
    return {k: (w[k].to(dtype) if k in MATS else w[k].to(dtype).float()) for k in W_KEYS}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def view_bias(half_mask: Optional[torch.Tensor], t: int, device) -> Optional[torch.Tensor]:
    """[t] bool half split -> [t, 2] f32 bias (0 inside the view, NEG_INF
    outside: half 1, then half 2), `_view_bias` (encoder_train.py:611-617);
    None without a split."""
    if half_mask is None:
        return None
    hm = half_mask.reshape(t).to(device=device, dtype=torch.bool)
    return torch.stack([torch.where(hm, 0.0, NEG_INF), torch.where(hm, NEG_INF, 0.0)],
                       dim=-1).float().contiguous()


def _views(l, vb):
    """The logits of each view: [l] without a view bias, else l plus each column."""
    if vb is None:
        return [l]
    return [l, l + vb[None, :, 0:1], l + vb[None, :, 1:2]]


def _pool_plain(l, y32, nh: int, e: int):
    """Per-head softmax pool of y32 [b, t, E] over l's unmasked tokens ->
    (pooled [b, E], m [b, nh], s [b, nh])."""
    b, t, _ = l.shape
    valid = l > MASKED_BIAS
    m = l.masked_fill(~valid, float("-inf")).amax(dim=1)           # [b, nh]
    m_live = torch.where(m > MASKED_BIAS, m, 0.0)  # a bag with no valid token: no inf - inf
    p = torch.where(valid, torch.exp(l - m_live[:, None]), 0.0)
    s = p.sum(dim=1).clamp_min(1e-30)
    pooled = torch.einsum("bth,bthe->bhe", p, y32.reshape(b, t, nh, e)) / s[..., None]
    return pooled.reshape(b, nh * e), m, s


def _rows_plain(x, w, seed: int, row_offset: int, pre_rate: float):
    """The forward's rows up to the residuals: (y32 [b, t, E] f32, a_pre,
    b_pre [b, t, nh, f] f32, saved: u1 u2 u3 a_pre b_pre in x.dtype and
    rstd [b, t, 3] f32). The forward and the recompute route's backward
    both call it, so their residuals are equal bit for bit."""
    dt = x.dtype
    b, t, _ = x.shape
    nh, f, _ = w["wa"].shape
    rows, toks = prng.site_rows(b, t, row_offset, x.device)
    _, _, y32, us, rstd = pa.stack_fwd_plain(x, w, seed, rows, toks, pre_rate)
    a_pre, b_pre = gl.gates_plain(y32.to(dt), w)
    saved = {"u1": us[0], "u2": us[1], "u3": us[2], "rstd": rstd,
             "ap": a_pre.reshape(b, t, nh * f).to(dt), "bp": b_pre.reshape(b, t, nh * f).to(dt)}
    return y32, a_pre, b_pre, saved


def encoder_train_fwd_plain(x, bias, w, seed: int, row_offset: int = 0,
                            pre_rate: float = PRE_RATE, gate_rate: float = GATE_RATE,
                            vb: Optional[torch.Tensor] = None, save: bool = True):
    """x [b, t, d_in] (compute dtype), bias [b, t] f32 (0 or NEG_INF), w:
    `train_operands`, vb: `view_bias` or None. Returns (pooled [b, E] f32,
    m [b, nh], s [b, nh] (with vb: [b, 3, E], [b, 3, nh], [b, 3, nh]),
    tok [b, t, d_out] in x.dtype, masked logits l [b, t, nh] f32, saved;
    None on the recompute route, save False)."""
    dt = x.dtype
    b, t, _ = x.shape
    nh, f, e = w["wa"].shape
    rows, toks = prng.site_rows(b, t, row_offset, x.device)
    y32, a_pre, b_pre, saved = _rows_plain(x, w, seed, row_offset, pre_rate)
    y = y32.to(dt)
    tok = linear_tok_fwd_plain(y, w["wt"], w["bt"])
    ma = gl.gate_masks(seed, rows, toks, nh, f, 0, gate_rate)
    mb = gl.gate_masks(seed, rows, toks, nh, f, 1, gate_rate)
    l = gl.logits_plain(a_pre, b_pre, ma, mb, w) + bias[..., None]
    pools = [_pool_plain(lv, y32, nh, e) for lv in _views(l, vb)]
    pooled, m, s = pools[0] if vb is None else (torch.stack(z, dim=1) for z in zip(*pools))
    return pooled, m, s, tok, l, saved if save else None


@torch.no_grad()
def encoder_train_bwd_plain(x, l, m, s, g, inner, dtok, saved, w, seed: int,
                            row_offset: int = 0, pre_rate: float = PRE_RATE,
                            gate_rate: float = GATE_RATE, need_dx: bool = False,
                            vb: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The explicit adjoint of `encoder_train_fwd_plain` (encoder_train.py:
    341-422, preattn.py::_layer_bwd): g [b, E] f32 the pooled cotangent,
    inner [b, nh] = per-head g . pooled, dtok [b, t, d_out] in x.dtype; with
    vb, g [b, 3, E] and inner, m, s [b, 3, nh], the views' terms summed.
    saved: the forward's residuals, or None on the recompute route (rebuilt
    here by the forward's `_rows_plain`). Returns {key of W_KEYS: f32
    gradient}, plus "x": dx [b, t, d_in] in x.dtype with need_dx."""
    dt = x.dtype
    b, t, _ = x.shape
    nh, f, e = w["wa"].shape
    E = nh * e
    if saved is None:
        saved = _rows_plain(x, w, seed, row_offset, pre_rate)[3]
    rows, toks = prng.site_rows(b, t, row_offset, x.device)
    res = pa.stack_residuals([saved["u1"], saved["u2"], saved["u3"]], saved["rstd"], w, seed,
                             rows, toks, pre_rate)
    y32 = res[3][1] * res[3][2] * res[3][3]
    y = y32.to(dt)

    # pool term, dl: per view, summed in view order (encoder_train.py:341-356)
    views = _views(l, vb)
    nv = len(views)
    g4, m, s, inner = (g.reshape(b, nv, 1, nh, e), m.reshape(b, nv, nh), s.reshape(b, nv, nh),
                       inner.reshape(b, nv, nh))
    for v, lv in enumerate(views):
        p = torch.where(lv > MASKED_BIAS, torch.exp(lv - m[:, v, None]) / s[:, v, None], 0.0)
        dy_v = (p[..., None] * g4[:, v]).reshape(b, t, E)
        dl_v = p * ((y32.reshape(b, t, nh, e) * g4[:, v]).sum(-1) - inner[:, v, None])
        dy, dl = (dy_v, dl_v) if v == 0 else (dy + dy_v, dl + dl_v)
    grads = {"bc": dl.sum((0, 1))}
    # token projector term
    dy_tok, grads["wt"], grads["bt"] = tok_bwd_plain(y, dtok, w["wt"])
    dy = dy + dy_tok
    # gate terms
    ap = saved["ap"].float().reshape(b, t, nh, f)
    bp = saved["bp"].float().reshape(b, t, nh, f)
    ma = gl.gate_masks(seed, rows, toks, nh, f, 0, gate_rate)
    mb = gl.gate_masks(seed, rows, toks, nh, f, 1, gate_rate)
    dy_gates, gate_grads = gl.gates_bwd_plain(ap, bp, ma, mb, dl, y, w)
    dy = dy + dy_gates
    grads.update(gate_grads)
    grads.update(pa.stack_bwd_plain(dy, x, res, w, need_dx))
    return grads


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

def _check_views(kernel, vb, t, device) -> int:
    """The view count of a view bias: 1 without one, else 3 after checking it."""
    if vb is None:
        return 1
    _build.check_operand(kernel, "vb", vb, (t, 2), torch.float32, device)
    return 3


def check_dtypes(x, w, kernel) -> torch.dtype:
    """The call's compute dtype, x's: bf16 or f32, with every matrix of MATS
    in it (the vectors are f32 on both routes). A mixed set raises a
    ValueError that names the first operand out of line."""
    return _build.check_dtypes(kernel, "x", x, w, W_KEYS, MATS)


def _check_shapes(x, w, kernel):
    dt = check_dtypes(x, w, kernel)
    if x.device.type != "cuda":
        raise ValueError(f"{kernel} kernel needs CUDA tensors, got {x.device}")
    b, t, d_in = x.shape
    nh, f, e = w["wa"].shape
    hd = w["w1"].shape[0]
    dout = w["wt"].shape[0]
    if (hd != e or e % 128 or f % 128 or nh * f > 4096 or nh * e > 4096 or d_in % 8
            or dout % 8 or dout > 4096 or b < 1 or t < 1):
        raise ValueError(f"{kernel} kernel: unsupported widths d_in={d_in}, hidden={hd}, "
                         f"e={e}, f={f}, nh={nh}, d_out={dout} (needs hidden = e, e and f "
                         f"multiples of 128, nh*e and nh*f <= 4096, d_in and d_out % 8 == 0)")
    shapes = {"w1": (hd, d_in), "b1": (hd,), "s1": (hd,), "t1": (hd,),
              "w2": (hd, hd), "b2": (hd,), "s2": (hd,), "t2": (hd,),
              "w3": (nh * e, hd), "b3": (nh * e,), "s3": (nh * e,), "t3": (nh * e,),
              "wa": (nh, f, e), "ba": (nh, f), "wb": (nh, f, e), "bb": (nh, f),
              "wc": (nh, f), "bc": (nh,), "wt": (dout, nh * e), "bt": (dout,)}
    for k, shape in shapes.items():
        _build.check_operand(kernel, k, w[k], shape, dt if k in MATS else torch.float32,
                             x.device)
        _build.check_aligned(kernel, k, w[k])
    _build.check_operand(kernel, "x", x, (b, t, d_in), dt, x.device)
    _build.check_aligned(kernel, "x", x)
    return b, t, d_in, hd, nh, e, f, dout


@torch.no_grad()
def encoder_train_fwd_cuda(x, bias, w, seed: int, row_offset: int = 0,
                           pre_rate: float = PRE_RATE, gate_rate: float = GATE_RATE,
                           vb: Optional[torch.Tensor] = None, save: bool = True):
    """Launch K6 on CUDA tensors, bf16 or f32 (x's dtype); returns as
    `encoder_train_fwd_plain` (with save False K6 writes no residuals)."""
    global fwd_launches, fwd_nosave_launches, fwd_f32_launches, fwd_f32_nosave_launches
    b, t, d_in, hd, nh, e, f, dout = _check_shapes(x, w, "encoder_train_fwd")
    _build.check_operand("encoder_train_fwd", "bias", bias, (b, t), torch.float32, x.device)
    nv = _check_views("encoder_train_fwd", vb, t, x.device)
    views = () if nv == 1 else (nv,)
    dev, f32, bf = x.device, torch.float32, x.dtype
    wide = bf == f32
    M, E = b * t, nh * e
    lib = _build.load("encoder_train_fwd")
    ntiles = -(-t // lib.encoder_train_pool_tile())   # ctypes' default restype is int
    wab, bab = permute_gates(w)                                    # [nh, 2f, e], [nh, 2f]
    pooled = torch.empty(b, *views, E, dtype=f32, device=dev)
    m = torch.empty(b, *views, nh, dtype=f32, device=dev)
    s = torch.empty(b, *views, nh, dtype=f32, device=dev)
    tok = torch.empty(b, t, dout, dtype=bf, device=dev)
    l = torch.empty(b, t, nh, dtype=f32, device=dev)
    saved = _saved_buffers(b, t, hd, E, nh * f, dev, bf) if save else None
    scratch = [torch.empty(M, max(hd, E), dtype=f32, device=dev),    # Z
               torch.empty(M, hd, dtype=bf, device=dev),            # H1
               torch.empty(M, hd, dtype=bf, device=dev),            # H2
               None if wide else torch.empty(M, E, dtype=bf, device=dev),   # Y (f32: y32 in Z)
               torch.empty(M, nh, f // GATE_CHUNK, dtype=f32, device=dev),   # partial logits
               torch.empty(b, ntiles, nv, nh, dtype=f32, device=dev),   # part_m
               torch.empty(b, ntiles, nv, nh, dtype=f32, device=dev),   # part_s
               torch.empty(b, ntiles, nv, E, dtype=f32, device=dev)]    # part_w
    dims, scales = prng.kernel_args((b, t, d_in, hd, nh, e, f, dout), seed, row_offset,
                                    pre_rate, gate_rate)
    # f32: the weights split into TF32 hi and lo (csrc/encoder_rows.cuh::split_fwd)
    splits = (torch.empty(_build.workspace("encoder_train_fwd", "encoder_train_fwd_workspace_f32",
                                           dims)[0], dtype=f32, device=dev) if wide else None)
    tensors = [x, bias, w["w1"], w["b1"], w["s1"], w["t1"], w["w2"], w["b2"], w["s2"],
               w["t2"], w["w3"], w["b3"], w["s3"], w["t3"], wab, bab, w["wc"], w["bc"],
               w["wt"], w["bt"], pooled, m, s, tok, l,
               *(saved[k] if save else None for k in SAVED), *scratch, vb, splits]
    _build.call_ptrs("encoder_train_fwd",
                     "encoder_train_forward_f32" if wide else "encoder_train_forward", tensors,
                     dims + [nv], scales, dev)
    if wide:
        fwd_f32_launches += 1
        fwd_f32_nosave_launches += not save
    else:
        fwd_launches += 1
        fwd_nosave_launches += not save
    return pooled, m, s, tok, l, saved


def _saved_buffers(b: int, t: int, hd: int, E: int, nhf: int, dev,
                   dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Uninitialised residual tensors of one call, SAVED's shapes: u1 u2 u3
    a_pre b_pre in the call's dtype, rstd f32 (the bytes `resolve_save_acts`
    reckons at its itemsize)."""
    return {"u1": torch.empty(b, t, hd, dtype=dtype, device=dev),
            "u2": torch.empty(b, t, hd, dtype=dtype, device=dev),
            "u3": torch.empty(b, t, E, dtype=dtype, device=dev),
            "ap": torch.empty(b, t, nhf, dtype=dtype, device=dev),
            "bp": torch.empty(b, t, nhf, dtype=dtype, device=dev),
            "rstd": torch.empty(b, t, 3, dtype=torch.float32, device=dev)}


@torch.no_grad()
def encoder_train_bwd_cuda(x, l, m, s, g, inner, dtok, saved, w, seed: int,
                           row_offset: int = 0, pre_rate: float = PRE_RATE,
                           gate_rate: float = GATE_RATE, need_dx: bool = False,
                           vb: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Launch K7 on CUDA tensors; returns as `encoder_train_bwd_plain`.
    With saved None, K7's recompute route: the residuals are rebuilt on the
    card into buffers that live for this call only (K6's device code, so the
    gradients equal the save route's bit for bit); its f32 scratch reuses
    DY's bytes ([M, E] f32, E = nh e >= hidden = e). bf16 or f32, x's
    dtype: the residuals, dtok and dx in it."""
    global bwd_launches, bwd_recompute_launches, bwd_f32_launches, bwd_f32_recompute_launches
    b, t, d_in, hd, nh, e, f, dout = _check_shapes(x, w, "encoder_train_bwd")
    dev, f32, bf = x.device, torch.float32, x.dtype
    wide = bf == f32
    M, E = b * t, nh * e
    kname = "encoder_train_bwd"
    nv = _check_views(kname, vb, t, dev)
    views = () if nv == 1 else (nv,)
    recompute = saved is None
    if recompute:
        saved = _saved_buffers(b, t, hd, E, nh * f, dev, bf)
    for name, ten, shape, dtype in (("l", l, (b, t, nh), f32), ("m", m, (b, *views, nh), f32),
                                    ("s", s, (b, *views, nh), f32),
                                    ("g", g, (b, *views, E), f32),
                                    ("inner", inner, (b, *views, nh), f32),
                                    ("dtok", dtok, (b, t, dout), bf),
                                    ("u1", saved["u1"], (b, t, hd), bf),
                                    ("u2", saved["u2"], (b, t, hd), bf),
                                    ("u3", saved["u3"], (b, t, E), bf),
                                    ("ap", saved["ap"], (b, t, nh * f), bf),
                                    ("bp", saved["bp"], (b, t, nh * f), bf),
                                    ("rstd", saved["rstd"], (b, t, 3), f32)):
        _build.check_operand(kname, name, ten, shape, dtype, dev)
        _build.check_aligned(kname, name, ten)
    dims, scales = prng.kernel_args((b, t, d_in, hd, nh, e, f, dout), seed, row_offset,
                                    pre_rate, gate_rate)
    # f32: a third workspace, the weights split into TF32 hi and lo
    ws = (_build.workspace(kname, "encoder_train_bwd_workspace_f32", dims, 3) if wide
          else _build.workspace(kname, "encoder_train_bwd_workspace", dims) + (0,))
    wab = torch.cat([w["wa"], w["wb"]], dim=1).contiguous()
    out = {"w1": (hd, d_in), "b1": (hd,), "s1": (hd,), "t1": (hd,),
           "w2": (hd, hd), "b2": (hd,), "s2": (hd,), "t2": (hd,),
           "w3": (E, hd), "b3": (E,), "s3": (E,), "t3": (E,),
           "wab": (nh, 2 * f, e), "bab": (nh, 2, f), "wc": (nh, f), "bc": (nh,),
           "wt": (dout, E), "bt": (dout,)}
    out = {k: torch.empty(shape, dtype=f32, device=dev) for k, shape in out.items()}
    scratch = [torch.empty(M, hd, dtype=bf, device=dev),            # H1
               torch.empty(M, hd, dtype=bf, device=dev),            # H2
               torch.empty(M, E, dtype=bf, device=dev),             # Y
               torch.empty(M, E, dtype=f32, device=dev),            # DY
               torch.empty(M, nh, dtype=f32, device=dev),           # DL
               torch.empty(M, 2 * nh * f, dtype=bf, device=dev),    # DZG
               torch.empty(M, E, dtype=bf, device=dev),             # DZ3
               torch.empty(M, hd, dtype=f32, device=dev),           # DH
               torch.empty(M, hd, dtype=bf, device=dev),            # DZ12
               torch.empty(ws[0], dtype=f32, device=dev),           # split-K partials
               torch.empty(ws[1], dtype=f32, device=dev)]           # column partials
    dx = torch.empty(b, t, d_in, dtype=bf, device=dev) if need_dx else None
    # the recompute route also reads the layer biases and K6's permuted gates
    fwd_only = ([w["b1"], w["b2"], w["b3"], *permute_gates(w)] if recompute
                else [None] * 5)
    splits = torch.empty(ws[2], dtype=f32, device=dev) if wide else None
    tensors = [x, l, m, s, g, inner, dtok, *(saved[k] for k in SAVED),
               w["w1"], w["s1"], w["t1"], w["w2"], w["s2"], w["t2"], w["w3"], w["s3"],
               w["t3"], wab, w["wc"], w["wt"], *out.values(), *scratch, dx, vb, *fwd_only,
               splits]
    _build.call_ptrs(kname, "encoder_train_backward_f32" if wide else "encoder_train_backward",
                     tensors, dims + [nv, int(recompute)], scales, dev)
    if wide:
        bwd_f32_launches += 1
        bwd_f32_recompute_launches += recompute
    else:
        bwd_launches += 1
        bwd_recompute_launches += recompute
    wab_g, bab_g = out.pop("wab"), out.pop("bab")
    out.update(wa=wab_g[:, :f], wb=wab_g[:, f:], ba=bab_g[:, 0], bb=bab_g[:, 1])
    if need_dx:
        out["x"] = dx
    return out


# ---------------------------------------------------------------------------
# blocks of whole bags
# ---------------------------------------------------------------------------

def _piece(v: Optional[torch.Tensor], b0: int, b1: int) -> Optional[torch.Tensor]:
    """Bags [b0, b1) of a per-bag tensor: a view, or a copy where the view
    would not start on the 16 bytes the kernels read from."""
    if v is None:
        return None
    p = v[b0:b1]
    return p if p.data_ptr() % 16 == 0 else p.clone()


def encoder_train_fwd_blocks(x, bias, w, seed: int, row_offset: int, pre_rate: float,
                             gate_rate: float, vb: Optional[torch.Tensor], save: bool,
                             blocks: Sequence[Tuple[int, int]]):
    """The forward (K6 on a CUDA tensor, else its plain version) of one
    call in `blocks` (contiguous, covering [0, b)): each block's outputs, at
    row offset row_offset + b0, copied into the call's; returns as
    `encoder_train_fwd_plain`. One block is one call of the wrapper."""
    global fwd_blocked_calls, fwd_blocks
    fwd = encoder_train_fwd_cuda if x.is_cuda else encoder_train_fwd_plain
    if len(blocks) == 1:
        return fwd(x, bias, w, seed, row_offset, pre_rate, gate_rate, vb=vb, save=save)
    b = x.shape[0]
    out = None
    for b0, b1 in blocks:
        part = fwd(_piece(x, b0, b1), _piece(bias, b0, b1), w, seed, row_offset + b0, pre_rate,
                   gate_rate, vb=vb, save=save)
        part = (*part[:5], part[5] or {})
        if out is None:
            out = [*(torch.empty((b, *v.shape[1:]), dtype=v.dtype, device=v.device)
                     for v in part[:5]),
                   {k: torch.empty((b, *v.shape[1:]), dtype=v.dtype, device=v.device)
                    for k, v in part[5].items()}]
        for whole, v in zip(out[:5], part[:5]):
            whole[b0:b1].copy_(v)
        for k, v in part[5].items():
            out[5][k][b0:b1].copy_(v)
        del part
    fwd_blocked_calls += 1
    fwd_blocks += len(blocks)
    return (*out[:5], out[5] if save else None)


@torch.no_grad()
def encoder_train_bwd_blocks(x, l, m, s, g, inner, dtok, saved, w, seed: int, row_offset: int,
                             pre_rate: float, gate_rate: float, need_dx: bool,
                             vb: Optional[torch.Tensor], blocks: Sequence[Tuple[int, int]]
                             ) -> Dict[str, torch.Tensor]:
    """The backward (K7 on a CUDA tensor, else its plain version) of one
    call in `blocks`: each block's gradients at row offset row_offset + b0,
    the f32 weight gradients summed in block order (no atomics, no order
    that depends on timing), dx copied into the call's; returns as
    `encoder_train_bwd_plain`."""
    global bwd_blocked_calls, bwd_blocks
    bwd = encoder_train_bwd_cuda if x.is_cuda else encoder_train_bwd_plain
    if len(blocks) == 1:
        return bwd(x, l, m, s, g, inner, dtok, saved, w, seed, row_offset, pre_rate, gate_rate,
                   need_dx=need_dx, vb=vb)
    grads, dx = None, None
    for b0, b1 in blocks:
        part = bwd(*(_piece(v, b0, b1) for v in (x, l, m, s, g, inner, dtok)),
                   None if saved is None else {k: _piece(v, b0, b1) for k, v in saved.items()},
                   w, seed, row_offset + b0, pre_rate, gate_rate, need_dx=need_dx, vb=vb)
        if need_dx:
            if dx is None:
                dx = torch.empty_like(x)
            dx[b0:b1].copy_(part.pop("x"))
        grads = part if grads is None else {k: grads[k] + part[k] for k in W_KEYS}
        del part
    bwd_blocked_calls += 1
    bwd_blocks += len(blocks)
    if need_dx:
        grads["x"] = dx
    return grads


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

class EncoderTrain(torch.autograd.Function):
    """(x, bias, vb, seed, row_offset, pre_rate, gate_rate, need_dx, save,
    blocks, *operands in W_KEYS order) -> (pooled [b, nh, e] in x.dtype ([b,
    3, nh, e] with a view bias vb), tok [b, t, d_out]). x gets a gradient
    only with need_dx (the input carries a learned component: the
    stain-encoding columns). With save False (the recompute route) the
    graph keeps only x, the weights and the forward's small outputs (l, m,
    s, pooled; JAX's `res`, encoder_train.py:641), and the backward rebuilds
    the residuals. Both directions run in `blocks` of whole bags."""

    @staticmethod
    def forward(ctx, x, bias, vb, seed, row_offset, pre_rate, gate_rate, need_dx, save, blocks,
                *ws):
        w = dict(zip(W_KEYS, ws))
        pooled32, m, s, tok, l, saved = encoder_train_fwd_blocks(
            x, bias, w, seed, row_offset, pre_rate, gate_rate, vb, save, blocks)
        ctx.args = (seed, row_offset, pre_rate, gate_rate)
        ctx.need_dx, ctx.save, ctx.blocks = need_dx, save, blocks
        kept = [saved[k] for k in SAVED] if save else []
        ctx.save_for_backward(x, l, m, s, pooled32, vb, *kept, *ws)
        nh, _, e = w["wa"].shape
        views = () if vb is None else (3,)
        return pooled32.to(x.dtype).reshape(x.shape[0], *views, nh, e), tok

    @staticmethod
    def backward(ctx, dpooled, dtok):
        x, l, m, s, pooled32, vb, *rest = ctx.saved_tensors
        n_saved = len(SAVED) if ctx.save else 0
        saved = dict(zip(SAVED, rest[:n_saved])) if ctx.save else None
        w = dict(zip(W_KEYS, rest[n_saved:]))
        b, t, _ = x.shape
        nh, _, e = w["wa"].shape
        dout = w["wt"].shape[0]
        gshape = pooled32.shape                                        # [b, E] or [b, 3, E]
        g = (torch.zeros(gshape, dtype=torch.float32, device=x.device) if dpooled is None
             else dpooled.float().reshape(gshape).contiguous())
        inner = (g * pooled32).reshape(*gshape[:-1], nh, e).sum(-1)   # encoder_train.py:657-659
        dtok = (torch.zeros(b, t, dout, dtype=x.dtype, device=x.device) if dtok is None
                else dtok.to(x.dtype).contiguous())
        grads = encoder_train_bwd_blocks(x, l, m, s, g, inner, dtok, saved, w, *ctx.args,
                                         ctx.need_dx, vb, ctx.blocks)
        return (grads.get("x"),) + (None,) * 9 + tuple(grads[k].to(w[k].dtype)
                                                        for k in W_KEYS)


def token_mask_bias(mask, b: int, t: int, device) -> torch.Tensor:
    """[b, t] f32 logit bias: 0 on valid tokens, NEG_INF on padding."""
    return mask_bias(mask, b, t, 1, torch.device(device)).reshape(b, t)


def encoder_train(x: torch.Tensor, mask, w: Dict[str, torch.Tensor], seed: int,
                  pre_rate: Optional[float] = None, gate_rate: Optional[float] = None,
                  row_offset: int = 0, need_dx: bool = False,
                  half_mask: Optional[torch.Tensor] = None, save_acts: Optional[bool] = None,
                  block_bags: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused training-mode encoder (ref semantics Model.py:110-146 +
    Model.py:350-417 + abmil.py:34-63). x [b, t, d_in] in the compute dtype,
    mask [b, t] bool or None, w: `train_operands` (the gradients flow back
    through them), seed: int. A rate left None is this module's PRE_RATE /
    GATE_RATE, read at call time. need_dx: x gets a gradient (JAX's static
    need_dx, madeleine.py:204). half_mask: [t] bool, the half-bag split
    shared by every row (n_views=3). save_acts: True the save route, False
    the recompute route, None `resolve_save_acts` by shape and memory (JAX's
    static save_acts). block_bags: the bags of each block the call runs
    in; None takes `encoder_blocks` by shape, dtype and the card's total
    memory (never its free memory: ROADMAP.md C1). Returns (pooled
    [b, nh, e], or [b, 3, nh, e] with half_mask: the whole bag, half 1,
    half 2; tok [b, t, d_out]), both in x.dtype."""
    b, t, d_in = x.shape
    pre_rate = PRE_RATE if pre_rate is None else pre_rate
    gate_rate = GATE_RATE if gate_rate is None else gate_rate
    nh, f, e = w["wa"].shape
    hd = w["w1"].shape[0]
    save = resolve_save_acts(save_acts, b, t, hd, nh * e, 2 * nh * f,
                             x.element_size(), x_bytes=x.numel() * x.element_size(),
                             device=x.device)
    if block_bags is None:
        blocks = encoder_blocks(b, t, (d_in, hd, nh, e, f, w["wt"].shape[0]), x.dtype,
                                not save, device_total_bytes(x.device), need_dx,
                                1 if half_mask is None else 3)
    else:
        blocks = [(b0, min(b0 + block_bags, b)) for b0 in range(0, b, block_bags)]
    bias = token_mask_bias(mask, b, t, x.device)
    vb = view_bias(half_mask, t, x.device)
    return EncoderTrain.apply(x.contiguous(), bias, vb, int(seed), int(row_offset),
                              float(pre_rate), float(gate_rate), bool(need_dx), save,
                              tuple(blocks), *(w[k] for k in W_KEYS))
