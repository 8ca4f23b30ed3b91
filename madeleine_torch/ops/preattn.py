"""Pre-attention MLP for training: kernel 15 (forward) and 16 (backward), bf16 or f32.

Replaces `madeleine_tpu/ops/preattn.py` (`_fwd_kernel`, `_bwd_kernel`,
`preattn_train`), the per-op lane's first op (ref: Model.py:350-363). Per
token row of x [b, t, d_in]:

    3 x [Linear -> LayerNorm (f32 statistics) -> GELU (exact erf) -> dropout(rate)]

widths d_in -> hidden -> hidden -> E = hidden * n_heads, output y [b, t, E]
head-major in x.dtype; bf16 or f32 operands (f32: the JAX package's
Precision.HIGHEST route, `--precision float32`), f32 accumulation, bias, LN
and GELU, each layer's output rounded to the compute dtype before the next
product.
Dropout masks come from `ops/prng.py` (Philox, streams 0-2 keyed by global
row and token), the masks of the whole-encoder op K6/K7 for the same (seed,
row_offset). The backward recomputes the stack from (x, seed), as the TPU
op does: autograd keeps x and nothing else.

Operands (`encoder_train.train_operands`): w1 [h, d_in], w2 [h, h], w3
[E, h] ([out, in] layout, compute dtype), biases b*, LN scales s* and
shifts t* (f32). The plain versions here also serve K6/K7's
(`encoder_train.py`). A CPU tensor takes them (any float dtype); a CUDA
tensor launches csrc/preattn.cu or raises. In bf16 both kernels run their
products on the TMA + wgmma GEMM, each followed by a warp-per-row LayerNorm
kernel; in f32 (`preattn_forward_f32`, `preattn_backward_f32`) on the FFMA
tiles of csrc/gemm_ffma.cuh with K6 f32's row kernel, K6/K7's f32 launch
sequences on `Gemm::FFMA` (K6/K7 themselves run `Gemm::TF32`). A mixed
bf16 / f32 operand set raises a ValueError naming the operand. The first
designs, on the mma.sync GEMM, bf16 only, stay reachable as
`preattn_fwd_rowblock_cuda` and `preattn_bwd_rowblock_cuda`, checks that
no path calls.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from madeleine_torch.ops import _build
from madeleine_torch.ops import prng

fwd_launches = 0   # kernel 15 launches (one per wrapper call on a bf16 CUDA tensor)
bwd_launches = 0   # kernel 16 launches
fwd_f32_launches = 0   # kernel 15 launches with f32 operands
bwd_f32_launches = 0   # kernel 16 launches with f32 operands
fwd_rowblock_launches = 0   # kernel 15's first design, the check-only entry point
bwd_rowblock_launches = 0   # kernel 16's first design, the check-only entry point

RATE = 0.1   # ref: Model.py:354,358,362 (read at call time)
LN_EPS = 1e-5
_INV_SQRT2 = 2.0 ** -0.5
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)

KEYS = ("w1", "b1", "s1", "t1", "w2", "b2", "s2", "t2", "w3", "b3", "s3", "t3")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def wide(x: torch.Tensor) -> torch.Tensor:
    """x in f32, or in f64 if it is f64 (the plain versions' arithmetic type:
    f32 for the kernels' operands, f64 for finite-difference checks)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [..., K] . w[N, K]^T in f32 (operands exact in their dtype)."""
    return torch.matmul(wide(a), wide(w).T)


def mm_nn(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [..., K] . w [K, N] in f32 (the input gradients' products against
    the weights as stored)."""
    return torch.matmul(wide(a), wide(w))


def token_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^T b summed over every token: a [..., M], b [..., N] with the same
    leading (token) axes -> [M, N] f32 (the weight gradients' products)."""
    return wide(a).reshape(-1, a.shape[-1]).T @ wide(b).reshape(-1, b.shape[-1])


def cdf(v: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.erf(v * _INV_SQRT2))


def stack_fwd_plain(x, w, seed: int, rows, toks, rate: float):
    """The three layers on x [b, t, d_in]. Returns (h1, h2, y32, us, rstd):
    the layer outputs h1, h2 in x.dtype (the next products' operands), layer
    3's f32 output y32, each layer's normalised LN input u in x.dtype and
    the three rstd [b, t, 3] f32."""
    dt = x.dtype
    h, hs, us, rstds = x, [], [], []
    for i in (1, 2, 3):
        z = mm(h, w[f"w{i}"]) + w[f"b{i}"]
        mean = z.mean(-1, keepdim=True)
        var = (z - mean).square().mean(-1, keepdim=True)
        rstd = torch.rsqrt(var + LN_EPS)
        u = (z - mean) * rstd
        v = u * w[f"s{i}"] + w[f"t{i}"]
        keep = prng.keep_mask(seed, rows, toks, i - 1, z.shape[-1], rate)
        h32 = v * cdf(v) * keep
        us.append(u.to(dt))
        rstds.append(rstd)
        h = h32.to(dt)
        hs.append(h)
    return hs[0], hs[1], h32, us, torch.cat(rstds, dim=-1)


def stack_residuals(us: List[torch.Tensor], rstd, w, seed: int, rows, toks, rate: float):
    """Per layer i (1..3) the backward's terms (u, v, Phi(v), mask, rstd_i),
    rebuilt elementwise from u (in the compute dtype) and rstd."""
    res = {}
    for i in (1, 2, 3):
        u = wide(us[i - 1])
        v = u * w[f"s{i}"] + w[f"t{i}"]
        keep = prng.keep_mask(seed, rows, toks, i - 1, u.shape[-1], rate)
        res[i] = (u, v, cdf(v), keep, rstd[..., i - 1:i])
    return res


def stack_bwd_plain(dy, x, res, w, need_dx: bool) -> Dict[str, torch.Tensor]:
    """The explicit adjoint of the three layers (preattn.py::_layer_bwd) from
    the cotangent dy [b, t, E] (f32, or f64) at layer 3's output. Returns {key of
    KEYS: f32 gradient}, plus "x": dx in x.dtype with need_dx."""
    dt = x.dtype
    grads = {}
    h1 = (res[1][1] * res[1][2] * res[1][3]).to(dt)
    h2 = (res[2][1] * res[2][2] * res[2][3]).to(dt)

    def layer_bwd(dout, hin, i, want_dx=True):
        u, v, P, keep, rstd = res[i]
        dv = dout * keep * (P + v * torch.exp(-0.5 * v * v) * _INV_SQRT_2PI)
        grads[f"s{i}"] = (dv * u).sum((0, 1))
        grads[f"t{i}"] = dv.sum((0, 1))
        du = dv * w[f"s{i}"]
        dz = (du - du.mean(-1, keepdim=True) - u * (du * u).mean(-1, keepdim=True)) * rstd
        dzc = wide(dz.to(dt))
        grads[f"w{i}"] = token_sum(dzc, hin)
        grads[f"b{i}"] = dz.sum((0, 1))
        return mm_nn(dzc, w[f"w{i}"]) if want_dx else None

    dh2 = layer_bwd(dy, h2, 3)
    dh1 = layer_bwd(dh2, h1, 2)
    dx = layer_bwd(dh1, x, 1, want_dx=need_dx)
    if need_dx:
        grads["x"] = dx.to(dt)
    return grads


def preattn_fwd_plain(x, w, seed: int, row_offset: int = 0, rate: float = RATE) -> torch.Tensor:
    """x [b, t, d_in] -> y [b, t, E] in x.dtype."""
    rows, toks = prng.site_rows(x.shape[0], x.shape[1], row_offset, x.device)
    return stack_fwd_plain(x, w, seed, rows, toks, rate)[2].to(x.dtype)


@torch.no_grad()
def preattn_bwd_plain(x, dy, w, seed: int, row_offset: int = 0, rate: float = RATE,
                      need_dx: bool = False) -> Dict[str, torch.Tensor]:
    """The adjoint of `preattn_fwd_plain` for the cotangent dy [b, t, E] (in
    x.dtype), recomputing the stack from (x, seed) as kernel 16 does.
    Returns {key of KEYS: f32 gradient}, plus "x" with need_dx."""
    rows, toks = prng.site_rows(x.shape[0], x.shape[1], row_offset, x.device)
    _, _, _, us, rstd = stack_fwd_plain(x, w, seed, rows, toks, rate)
    res = stack_residuals(us, rstd, w, seed, rows, toks, rate)
    return stack_bwd_plain(wide(dy), x, res, w, need_dx)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

MATS = ("w1", "w2", "w3")


def check_dtypes(x, w, kernel) -> torch.dtype:
    """The call's compute dtype, x's: bf16 or f32, with w1, w2, w3 in it and
    the vectors f32. A mixed set raises a ValueError naming the operand."""
    return _build.check_dtypes(kernel, "x", x, w, KEYS, MATS)


def _check(x, w, kernel) -> Tuple[int, int, int, int, int, torch.dtype]:
    """(b, t, d_in, hidden, E, compute dtype) after the operand checks: CUDA
    tensors, `check_dtypes`, the widths the kernels take."""
    if x.device.type != "cuda":
        raise ValueError(f"{kernel} kernel needs CUDA tensors, got {x.device}")
    dt = check_dtypes(x, w, kernel)
    b, t, d_in = x.shape
    hd, E = w["w1"].shape[0], w["w3"].shape[0]
    if hd % 128 or E % 128 or E > 4096 or d_in % 8 or b < 1 or t < 1:
        raise ValueError(f"{kernel} kernel: unsupported widths d_in={d_in}, hidden={hd}, "
                         f"E={E} (needs hidden and E multiples of 128, E <= 4096, "
                         f"d_in % 8 == 0)")
    shapes = {"w1": (hd, d_in), "w2": (hd, hd), "w3": (E, hd)}
    for k in KEYS:
        mat = k in shapes
        shape = shapes[k] if mat else ((E,) if k.endswith("3") else (hd,))
        _build.check_operand(kernel, k, w[k], shape, dt if mat else torch.float32, x.device)
    _build.check_operand(kernel, "x", x, (b, t, d_in), dt, x.device)
    return b, t, d_in, hd, E, dt


def entry_of(fns: Dict[torch.dtype, str], dt: torch.dtype, kernel: str) -> str:
    """The C entry point of `fns` for the compute dtype dt; a first design,
    kept as a check, has a bf16 one only."""
    if dt not in fns:
        raise ValueError(f"{kernel} kernel runs in bf16 only (a first design, kept as a "
                         f"check), got {dt}")
    return fns[dt]


def _fwd_launch(x, w, seed, row_offset, rate, kernel, fns, need_rstd):
    """Launch the entry point of `fns` for x's dtype in csrc/preattn.cu, a
    forward of kernel 15's interface (rstd scratch only where `need_rstd`);
    returns (y as `preattn_fwd_plain`, the compute dtype)."""
    b, t, d_in, hd, E, dt = _check(x, w, kernel)
    fn = entry_of(fns, dt, kernel)
    _build.check_aligned(kernel, "x", x)
    dev, M = x.device, b * t
    y = torch.empty(b, t, E, dtype=dt, device=dev)
    scratch = [torch.empty(M, max(hd, E), dtype=torch.float32, device=dev),   # Z
               torch.empty(M, 3, dtype=torch.float32, device=dev) if need_rstd else None,
               torch.empty(M, hd, dtype=dt, device=dev),                      # H1
               torch.empty(M, hd, dtype=dt, device=dev)]                      # H2
    dims, scales = prng.kernel_args((b, t, d_in, hd, E), seed, row_offset, rate)
    _build.call_ptrs("preattn", fn, [x, *(w[k] for k in KEYS), y, *scratch], dims, scales, dev)
    return y, dt


@torch.no_grad()
def preattn_fwd_cuda(x, w, seed: int, row_offset: int = 0, rate: float = RATE) -> torch.Tensor:
    """Launch kernel 15 on CUDA tensors, bf16 or f32 (x's dtype); returns as
    `preattn_fwd_plain`. Raises where the GEMM refuses an operand."""
    global fwd_launches, fwd_f32_launches
    y, dt = _fwd_launch(x, w, seed, row_offset, rate, "preattn_fwd",
                        {torch.bfloat16: "preattn_forward",
                         torch.float32: "preattn_forward_f32"}, False)
    if dt == torch.float32:
        fwd_f32_launches += 1
    else:
        fwd_launches += 1
    return y


@torch.no_grad()
def preattn_fwd_rowblock_cuda(x, w, seed: int, row_offset: int = 0,
                              rate: float = RATE) -> torch.Tensor:
    """Kernel 15's first design (the mma.sync GEMM, a block per LN row),
    kept as a check of the redesign; no path calls it. bf16 only. Returns
    as `preattn_fwd_plain`."""
    global fwd_rowblock_launches
    y, _ = _fwd_launch(x, w, seed, row_offset, rate, "preattn_fwd_rowblock",
                       {torch.bfloat16: "preattn_forward_rowblock"}, True)
    fwd_rowblock_launches += 1
    return y


def _bwd_launch(x, dy, w, seed, row_offset, rate, need_dx, kernel, fns):
    """Launch the entry point of `fns` for x's dtype in csrc/preattn.cu, a
    (backward, workspace sizes) pair of kernel 16's interface; returns
    (grads as `preattn_bwd_plain`, the compute dtype)."""
    b, t, d_in, hd, E, dt = _check(x, w, kernel)
    fn, ws_fn = entry_of(fns, dt, kernel)
    _build.check_operand(kernel, "dy", dy, (b, t, E), dt, x.device)
    for name, ten in (("x", x), ("dy", dy)):
        _build.check_aligned(kernel, name, ten)
    dev, M, f32 = x.device, b * t, torch.float32
    dims, scales = prng.kernel_args((b, t, d_in, hd, E), seed, row_offset, rate)
    ws = _build.workspace("preattn", ws_fn, dims)
    grads = {k: torch.empty(w[k].shape, dtype=f32, device=dev) for k in KEYS}
    Z = torch.empty(M, max(hd, E), dtype=f32, device=dev)
    scratch = [Z,
               torch.empty(M, hd, dtype=dt, device=dev),             # U1
               torch.empty(M, hd, dtype=dt, device=dev),             # U2
               torch.empty(M, E, dtype=dt, device=dev),              # U3
               torch.empty(M, 3, dtype=f32, device=dev),             # rstd
               torch.empty(M, hd, dtype=dt, device=dev),             # H1
               torch.empty(M, hd, dtype=dt, device=dev),             # H2
               Z if dt == f32 else torch.empty(M, E, dtype=dt, device=dev),   # DZ3 (f32: Z)
               torch.empty(M, hd, dtype=f32, device=dev),            # DH
               torch.empty(M, hd, dtype=dt, device=dev),             # DZ12
               torch.empty(ws[0], dtype=f32, device=dev),            # split-K partials
               torch.empty(ws[1], dtype=f32, device=dev)]            # column partials
    dx = torch.empty(b, t, d_in, dtype=dt, device=dev) if need_dx else None
    _build.call_ptrs("preattn", fn, [x, dy, *(w[k] for k in KEYS), *grads.values(), *scratch, dx],
                     dims, scales, dev)
    if need_dx:
        grads["x"] = dx
    return grads, dt


@torch.no_grad()
def preattn_bwd_cuda(x, dy, w, seed: int, row_offset: int = 0, rate: float = RATE,
                     need_dx: bool = False) -> Dict[str, torch.Tensor]:
    """Launch kernel 16 on CUDA tensors, bf16 or f32 (x's dtype, dy's and
    dx's too); returns as `preattn_bwd_plain`. Raises where the GEMM
    refuses an operand."""
    global bwd_launches, bwd_f32_launches
    grads, dt = _bwd_launch(x, dy, w, seed, row_offset, rate, need_dx, "preattn_bwd",
                            {torch.bfloat16: ("preattn_backward", "preattn_bwd_workspace"),
                             torch.float32: ("preattn_backward_f32",
                                             "preattn_bwd_workspace_f32")})
    if dt == torch.float32:
        bwd_f32_launches += 1
    else:
        bwd_launches += 1
    return grads


@torch.no_grad()
def preattn_bwd_rowblock_cuda(x, dy, w, seed: int, row_offset: int = 0, rate: float = RATE,
                              need_dx: bool = False) -> Dict[str, torch.Tensor]:
    """Kernel 16's first design (the mma.sync GEMM, a block per LN row),
    kept as a check of the redesign; no path calls it. bf16 only. Returns as
    `preattn_bwd_plain`."""
    global bwd_rowblock_launches
    grads, _ = _bwd_launch(x, dy, w, seed, row_offset, rate, need_dx, "preattn_bwd_rowblock",
                           {torch.bfloat16: ("preattn_backward_rowblock",
                                             "preattn_bwd_rowblock_workspace")})
    bwd_rowblock_launches += 1
    return grads


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

class PreattnTrain(torch.autograd.Function):
    """(x, seed, row_offset, rate, *operands in KEYS order) -> y [b, t, E] in
    x.dtype. The backward computes dx only when x needs a gradient (it
    carries the learned stain-encoding columns)."""

    @staticmethod
    def forward(ctx, x, seed, row_offset, rate, *ws):
        w = dict(zip(KEYS, ws))
        fwd = preattn_fwd_cuda if x.is_cuda else preattn_fwd_plain
        y = fwd(x, w, seed, row_offset, rate)
        ctx.args = (seed, row_offset, rate)
        ctx.save_for_backward(x, *ws)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, *ws = ctx.saved_tensors
        w = dict(zip(KEYS, ws))
        bwd = preattn_bwd_cuda if x.is_cuda else preattn_bwd_plain
        need_dx = ctx.needs_input_grad[0]
        grads = bwd(x, dy.to(x.dtype).contiguous(), w, *ctx.args, need_dx=need_dx)
        return (grads.get("x"), None, None, None) + tuple(grads[k].to(w[k].dtype) for k in KEYS)


def preattn_train(x: torch.Tensor, w: Dict[str, torch.Tensor], seed: int,
                  row_offset: int = 0, rate: Optional[float] = None) -> torch.Tensor:
    """Training-mode pre-attention MLP with its dropout (JAX
    `preattn_train`). x [b, t, d_in] in the compute dtype, w: the operands
    (`encoder_train.train_operands`; gradients flow back through them),
    seed: int, row_offset: the global batch row of x's first row, rate:
    None reads RATE at call time. Returns y [b, t, E] in x.dtype."""
    rate = RATE if rate is None else rate
    return PreattnTrain.apply(x.contiguous(), int(seed), int(row_offset), float(rate),
                              *(w[k] for k in KEYS))
