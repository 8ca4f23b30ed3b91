"""Pre-attention MLP for training: kernel 15 (forward) and 16 (backward), bf16.

Replaces `madeleine_tpu/ops/preattn.py` (`_fwd_kernel`, `_bwd_kernel`,
`preattn_train`), the per-op lane's first op (ref: Model.py:350-363). Per
token row of x [b, t, d_in]:

    3 x [Linear -> LayerNorm (f32 statistics) -> GELU (exact erf) -> dropout(rate)]

widths d_in -> hidden -> hidden -> E = hidden * n_heads, output y [b, t, E]
head-major in x.dtype; bf16 operands, f32 accumulation, bias, LN and GELU,
each layer's output rounded to the compute dtype before the next product.
Dropout masks come from `ops/prng.py` (Philox, streams 0-2 keyed by global
row and token), the masks of the whole-encoder op K6/K7 for the same (seed,
row_offset). The backward recomputes the stack from (x, seed), as the TPU
op does: autograd keeps x and nothing else.

Operands (`encoder_train.train_operands`): w1 [h, d_in], w2 [h, h], w3
[E, h] ([out, in] layout, compute dtype), biases b*, LN scales s* and
shifts t* (f32). The plain versions here also serve K6/K7's
(`encoder_train.py`). A CPU tensor takes them (any float dtype); a CUDA
tensor launches csrc/preattn.cu, bf16 only, or raises.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from madeleine_torch.ops import _build
from madeleine_torch.ops import prng

fwd_launches = 0   # kernel 15 launches (one per wrapper call on a CUDA tensor)
bwd_launches = 0   # kernel 16 launches

RATE = 0.1   # ref: Model.py:354,358,362 (read at call time)
LN_EPS = 1e-5
_INV_SQRT2 = 2.0 ** -0.5
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)

KEYS = ("w1", "b1", "s1", "t1", "w2", "b2", "s2", "t2", "w3", "b3", "s3", "t3")
F32_TODO = "ROADMAP.md D4: f32 operands for the train kernels"


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
        grads[f"w{i}"] = dzc.reshape(-1, dz.shape[-1]).T @ wide(hin).reshape(-1, hin.shape[-1])
        grads[f"b{i}"] = dz.sum((0, 1))
        return torch.matmul(dzc, wide(w[f"w{i}"])) if want_dx else None

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

def _check(x, w, kernel) -> Tuple[int, int, int, int, int]:
    if x.device.type != "cuda":
        raise ValueError(f"{kernel} kernel needs CUDA tensors, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise NotImplementedError(f"{kernel} kernel runs in bf16 only, got {x.dtype} "
                                  f"({F32_TODO})")
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
        _build.check_operand(kernel, k, w[k], shape,
                             torch.bfloat16 if mat else torch.float32, x.device)
    _build.check_operand(kernel, "x", x, (b, t, d_in), torch.bfloat16, x.device)
    return b, t, d_in, hd, E


@torch.no_grad()
def preattn_fwd_cuda(x, w, seed: int, row_offset: int = 0, rate: float = RATE) -> torch.Tensor:
    """Launch kernel 15 on CUDA tensors; returns as `preattn_fwd_plain`."""
    global fwd_launches
    b, t, d_in, hd, E = _check(x, w, "preattn_fwd")
    dev, M = x.device, b * t
    y = torch.empty(b, t, E, dtype=torch.bfloat16, device=dev)
    scratch = [torch.empty(M, max(hd, E), dtype=torch.float32, device=dev),   # Z
               torch.empty(M, 3, dtype=torch.float32, device=dev),            # rstd
               torch.empty(M, hd, dtype=torch.bfloat16, device=dev),          # H1
               torch.empty(M, hd, dtype=torch.bfloat16, device=dev)]          # H2
    dims, scales = prng.kernel_args((b, t, d_in, hd, E), seed, row_offset, rate)
    _build.call_ptrs("preattn", "preattn_forward", [x, *(w[k] for k in KEYS), y, *scratch],
                     dims, scales, dev)
    fwd_launches += 1
    return y


@torch.no_grad()
def preattn_bwd_cuda(x, dy, w, seed: int, row_offset: int = 0, rate: float = RATE,
                     need_dx: bool = False) -> Dict[str, torch.Tensor]:
    """Launch kernel 16 on CUDA tensors; returns as `preattn_bwd_plain`."""
    global bwd_launches
    b, t, d_in, hd, E = _check(x, w, "preattn_bwd")
    _build.check_operand("preattn_bwd", "dy", dy, (b, t, E), torch.bfloat16, x.device)
    dev, M, f32, bf = x.device, b * t, torch.float32, torch.bfloat16
    dims, scales = prng.kernel_args((b, t, d_in, hd, E), seed, row_offset, rate)
    ws = _build.workspace("preattn", "preattn_bwd_workspace", dims)
    grads = {k: torch.empty(w[k].shape, dtype=f32, device=dev) for k in KEYS}
    scratch = [torch.empty(M, max(hd, E), dtype=f32, device=dev),   # Z
               torch.empty(M, hd, dtype=bf, device=dev),            # U1
               torch.empty(M, hd, dtype=bf, device=dev),            # U2
               torch.empty(M, E, dtype=bf, device=dev),             # U3
               torch.empty(M, 3, dtype=f32, device=dev),            # rstd
               torch.empty(M, hd, dtype=bf, device=dev),            # H1
               torch.empty(M, hd, dtype=bf, device=dev),            # H2
               torch.empty(M, E, dtype=bf, device=dev),             # DZ3
               torch.empty(M, hd, dtype=f32, device=dev),           # DH
               torch.empty(M, hd, dtype=bf, device=dev),            # DZ12
               torch.empty(ws[0], dtype=f32, device=dev),           # split-K partials
               torch.empty(ws[1], dtype=f32, device=dev)]           # column partials
    dx = torch.empty(b, t, d_in, dtype=bf, device=dev) if need_dx else None
    _build.call_ptrs("preattn", "preattn_backward",
                     [x, dy, *(w[k] for k in KEYS), *grads.values(), *scratch, dx],
                     dims, scales, dev)
    bwd_launches += 1
    if need_dx:
        grads["x"] = dx
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
