"""Whole-encoder training op: kernel K6 (forward) and K7 (backward), bf16.

Replaces `madeleine_tpu/ops/encoder_train.py` (`_fwd_kernel`, `_bwd_kernel`,
the save_acts route, n_views=1, need_dx off and on). Per token row of x:

    3 x [Linear -> LayerNorm -> GELU (exact erf) -> dropout(pre_rate)] -> y32
    tok = y Wt^T + bt
    per head: a = drop(tanh(y_h Wa_h^T + ba)), g = drop(sigmoid(y_h Wb_h^T + bb)),
              l_h = (a g) . wc_h + bc_h + mask bias
    pooled = per-head softmax pool of y32 over the bag's tokens

with bf16 operands, f32 accumulation and f32 bias / LN / GELU; each layer's
output is rounded to bf16 before the next product, the pool sums f32 y32.
The forward saves u1, u2, u3 (normalised LN inputs), a_pre, b_pre (bf16)
and the three LN rstd (f32); the backward rebuilds every activation from
them elementwise and never recomputes a forward product. With need_dx (the
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
and csrc/encoder_train_bwd.cu, bf16 only, or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from madeleine_torch.ops import _build
from madeleine_torch.ops import prng
from madeleine_torch.ops.attn_pool import MASKED_BIAS, mask_bias

fwd_launches = 0   # K6 launches (one per wrapper call on a CUDA tensor)
bwd_launches = 0   # K7 launches

PRE_RATE = 0.1    # ref: Model.py:354,358,362
GATE_RATE = 0.25  # ref: abmil.py:34-35
LN_EPS = 1e-5
_INV_SQRT2 = 2.0 ** -0.5
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)

W_KEYS = ("w1", "b1", "s1", "t1", "w2", "b2", "s2", "t2", "w3", "b3", "s3", "t3",
          "wa", "ba", "wb", "bb", "wc", "bc", "wt", "bt")
MATS = ("w1", "w2", "w3", "wa", "wb", "wt")
SAVED = ("u1", "u2", "u3", "ap", "bp", "rstd")
F32_TODO = "ROADMAP.md D4: an f32 variant of K6/K7"


def train_operands(w: Dict[str, torch.Tensor], dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The op's operand types from head-major tensors (kept in the autograd
    graph): every tensor rounded to `dtype` (the compute-dtype copy of the
    f32 master weights), then vectors widened to f32, as the JAX package's
    _weight_args does after its parameter cast."""
    return {k: (w[k].to(dtype) if k in MATS else w[k].to(dtype).float()) for k in W_KEYS}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [..., K] . w[N, K]^T in f32 (operands exact in their dtype)."""
    return torch.matmul(a.float(), w.float().T)


def _cdf(v: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.erf(v * _INV_SQRT2))


def _gate_masks(seed, rows, toks, nh, f, branch, rate):
    return torch.stack([prng.keep_mask(seed, rows, toks, prng.gate_stream(h, branch), f, rate)
                        for h in range(nh)], dim=2)               # [b, t, nh, f]


def encoder_train_fwd_plain(x, bias, w, seed: int, row_offset: int = 0,
                            pre_rate: float = PRE_RATE, gate_rate: float = GATE_RATE):
    """x [b, t, d_in] (compute dtype), bias [b, t] f32 (0 or NEG_INF), w:
    `train_operands`. Returns (pooled [b, E] f32, m [b, nh], s [b, nh],
    tok [b, t, d_out] in x.dtype, masked logits l [b, t, nh] f32, saved)."""
    dt = x.dtype
    b, t, _ = x.shape
    nh, f, e = w["wa"].shape
    E = nh * e
    rows, toks = prng.site_rows(b, t, row_offset, x.device)
    saved, rstds = {}, []

    def layer(hin, i):
        z = _mm(hin, w[f"w{i}"]) + w[f"b{i}"]
        mean = z.mean(-1, keepdim=True)
        var = (z - mean).square().mean(-1, keepdim=True)
        rstd = torch.rsqrt(var + LN_EPS)
        u = (z - mean) * rstd
        v = u * w[f"s{i}"] + w[f"t{i}"]
        keep = prng.keep_mask(seed, rows, toks, i - 1, z.shape[-1], pre_rate)
        saved[f"u{i}"] = u.to(dt)
        rstds.append(rstd)
        return v * _cdf(v) * keep

    h1 = layer(x, 1)
    h2 = layer(h1.to(dt), 2)
    y32 = layer(h2.to(dt), 3)
    y = y32.to(dt)
    tok = (_mm(y, w["wt"]) + w["bt"]).to(dt)
    yh = y.float().reshape(b, t, nh, e)
    a_pre = torch.tanh(torch.einsum("bthe,hfe->bthf", yh, w["wa"].float()) + w["ba"])
    b_pre = torch.sigmoid(torch.einsum("bthe,hfe->bthf", yh, w["wb"].float()) + w["bb"])
    ma = _gate_masks(seed, rows, toks, nh, f, 0, gate_rate)
    mb = _gate_masks(seed, rows, toks, nh, f, 1, gate_rate)
    l = ((a_pre * ma) * (b_pre * mb) * w["wc"]).sum(-1) + w["bc"] + bias[..., None]
    valid = l > MASKED_BIAS
    m = l.masked_fill(~valid, float("-inf")).amax(dim=1)           # [b, nh]
    m_live = torch.where(m > MASKED_BIAS, m, 0.0)  # a bag with no valid token: no inf - inf
    p = torch.where(valid, torch.exp(l - m_live[:, None]), 0.0)
    s = p.sum(dim=1).clamp_min(1e-30)
    pooled = torch.einsum("bth,bthe->bhe", p, y32.reshape(b, t, nh, e)) / s[..., None]
    saved["ap"] = a_pre.reshape(b, t, nh * f).to(dt)
    saved["bp"] = b_pre.reshape(b, t, nh * f).to(dt)
    saved["rstd"] = torch.cat(rstds, dim=-1)
    return pooled.reshape(b, E), m, s, tok, l, saved


@torch.no_grad()
def encoder_train_bwd_plain(x, l, m, s, g, inner, dtok, saved, w, seed: int,
                            row_offset: int = 0, pre_rate: float = PRE_RATE,
                            gate_rate: float = GATE_RATE,
                            need_dx: bool = False) -> Dict[str, torch.Tensor]:
    """The explicit adjoint of `encoder_train_fwd_plain` (encoder_train.py:
    341-422, preattn.py::_layer_bwd): g [b, E] f32 the pooled cotangent,
    inner [b, nh] = per-head g . pooled, dtok [b, t, d_out] in x.dtype.
    Returns {key of W_KEYS: f32 gradient}, plus "x": dx [b, t, d_in] in
    x.dtype with need_dx."""
    dt = x.dtype
    b, t, _ = x.shape
    nh, f, e = w["wa"].shape
    E = nh * e
    rows, toks = prng.site_rows(b, t, row_offset, x.device)
    grads = {}
    res = {}
    for i, width in ((1, w["w1"].shape[0]), (2, w["w2"].shape[0]), (3, E)):
        u = saved[f"u{i}"].float()
        v = u * w[f"s{i}"] + w[f"t{i}"]
        keep = prng.keep_mask(seed, rows, toks, i - 1, width, pre_rate)
        P = _cdf(v)
        res[i] = (u, v, P, keep, saved["rstd"][..., i - 1:i])
    h1 = (res[1][1] * res[1][2] * res[1][3]).to(dt)
    h2 = (res[2][1] * res[2][2] * res[2][3]).to(dt)
    y32 = res[3][1] * res[3][2] * res[3][3]
    y = y32.to(dt)

    # pool term, dl
    p = torch.where(l > MASKED_BIAS, torch.exp(l - m[:, None]) / s[:, None], 0.0)
    g4 = g.reshape(b, 1, nh, e)
    dy = (p[..., None] * g4).reshape(b, t, E)
    dl = p * ((y32.reshape(b, t, nh, e) * g4).sum(-1) - inner[:, None])
    grads["bc"] = dl.sum((0, 1))
    # token projector term
    dy = dy + torch.matmul(dtok.float(), w["wt"].float())
    grads["wt"] = dtok.float().reshape(-1, dtok.shape[-1]).T @ y.float().reshape(-1, E)
    grads["bt"] = dtok.float().sum((0, 1))
    # gate terms
    ap = saved["ap"].float().reshape(b, t, nh, f)
    bp = saved["bp"].float().reshape(b, t, nh, f)
    ma = _gate_masks(seed, rows, toks, nh, f, 0, gate_rate)
    mb = _gate_masks(seed, rows, toks, nh, f, 1, gate_rate)
    a, bv = ap * ma, bp * mb
    dl4 = dl[..., None]
    grads["wc"] = ((a * bv) * dl4).sum((0, 1))
    dg = dl4 * w["wc"]
    dza = dg * bv * ma * (1.0 - ap * ap)
    dzb = dg * a * mb * bp * (1.0 - bp)
    dza_c, dzb_c = dza.to(dt).float(), dzb.to(dt).float()
    dy = dy + (torch.einsum("bthf,hfe->bthe", dza_c, w["wa"].float())
               + torch.einsum("bthf,hfe->bthe", dzb_c, w["wb"].float())).reshape(b, t, E)
    yh = y.float().reshape(b, t, nh, e)
    grads["wa"] = torch.einsum("bthf,bthe->hfe", dza_c, yh)
    grads["wb"] = torch.einsum("bthf,bthe->hfe", dzb_c, yh)
    grads["ba"] = dza.sum((0, 1))
    grads["bb"] = dzb.sum((0, 1))

    def layer_bwd(dout, hin, i, want_dx=True):
        u, v, P, keep, rstd = res[i]
        dv = dout * keep * (P + v * torch.exp(-0.5 * v * v) * _INV_SQRT_2PI)
        grads[f"s{i}"] = (dv * u).sum((0, 1))
        grads[f"t{i}"] = dv.sum((0, 1))
        du = dv * w[f"s{i}"]
        dz = (du - du.mean(-1, keepdim=True) - u * (du * u).mean(-1, keepdim=True)) * rstd
        dzc = dz.to(dt).float()
        grads[f"w{i}"] = dzc.reshape(-1, dz.shape[-1]).T @ hin.float().reshape(-1, hin.shape[-1])
        grads[f"b{i}"] = dz.sum((0, 1))
        return torch.matmul(dzc, w[f"w{i}"].float()) if want_dx else None

    dh2 = layer_bwd(dy, h2, 3)
    dh1 = layer_bwd(dh2, h1, 2)
    dx = layer_bwd(dh1, x, 1, want_dx=need_dx)
    if need_dx:
        grads["x"] = dx.to(dt)
    return grads


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

def _check_shapes(x, w, kernel):
    if x.device.type != "cuda":
        raise ValueError(f"{kernel} kernel needs CUDA tensors, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise NotImplementedError(f"{kernel} kernel runs in bf16 only, got {x.dtype} "
                                  f"({F32_TODO})")
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
        _build.check_operand(kernel, k, w[k], shape,
                             torch.bfloat16 if k in MATS else torch.float32, x.device)
    _build.check_operand(kernel, "x", x, (b, t, d_in), torch.bfloat16, x.device)
    return b, t, d_in, hd, nh, e, f, dout


def _dims(shape, seed, row_offset, pre_rate, gate_rate):
    thr_pre, scale_pre = prng.threshold(pre_rate)
    thr_gate, scale_gate = prng.threshold(gate_rate)
    # the f32 scales the plain masks use
    scales = [float(torch.tensor(scale_pre, dtype=torch.float32)),
              float(torch.tensor(scale_gate, dtype=torch.float32))]
    dims = (ctypes.c_longlong * 12)(*shape, int(seed) & prng.MASK32, int(row_offset),
                                    thr_pre, thr_gate)
    return dims, (ctypes.c_float * 2)(*scales)


def _call(fn, tensors, dims, scales, device):
    """The C entry point on the device's current stream; a None tensor
    passes as a null pointer."""
    ptrs = (ctypes.c_void_p * len(tensors))(*(None if x is None else x.data_ptr()
                                              for x in tensors))
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(ptrs, dims, scales, ctypes.c_void_p(stream))
    return err


@torch.no_grad()
def encoder_train_fwd_cuda(x, bias, w, seed: int, row_offset: int = 0,
                           pre_rate: float = PRE_RATE, gate_rate: float = GATE_RATE):
    """Launch K6 on CUDA tensors; returns as `encoder_train_fwd_plain`."""
    global fwd_launches
    b, t, d_in, hd, nh, e, f, dout = _check_shapes(x, w, "encoder_train_fwd")
    _build.check_operand("encoder_train_fwd", "bias", bias, (b, t), torch.float32, x.device)
    dev, f32, bf = x.device, torch.float32, torch.bfloat16
    M, E = b * t, nh * e
    lib = _build.load("encoder_train_fwd")
    ntiles = -(-t // lib.encoder_train_pool_tile())   # ctypes' default restype is int
    wab = torch.cat([w["wa"], w["wb"]], dim=1).contiguous()        # [nh, 2f, e]
    bab = torch.cat([w["ba"], w["bb"]], dim=1).contiguous()        # [nh, 2f]
    pooled = torch.empty(b, E, dtype=f32, device=dev)
    m = torch.empty(b, nh, dtype=f32, device=dev)
    s = torch.empty(b, nh, dtype=f32, device=dev)
    tok = torch.empty(b, t, dout, dtype=bf, device=dev)
    l = torch.empty(b, t, nh, dtype=f32, device=dev)
    saved = {"u1": torch.empty(b, t, hd, dtype=bf, device=dev),
             "u2": torch.empty(b, t, hd, dtype=bf, device=dev),
             "u3": torch.empty(b, t, E, dtype=bf, device=dev),
             "ap": torch.empty(b, t, nh * f, dtype=bf, device=dev),
             "bp": torch.empty(b, t, nh * f, dtype=bf, device=dev),
             "rstd": torch.empty(b, t, 3, dtype=f32, device=dev)}
    scratch = [torch.empty(M, max(hd, E), dtype=f32, device=dev),    # Z
               torch.empty(M, hd, dtype=bf, device=dev),            # H1
               torch.empty(M, hd, dtype=bf, device=dev),            # H2
               torch.empty(M, E, dtype=bf, device=dev),             # Y
               torch.empty(M, 2 * nh * f, dtype=f32, device=dev),   # G
               torch.empty(b, ntiles, nh, dtype=f32, device=dev),   # part_m
               torch.empty(b, ntiles, nh, dtype=f32, device=dev),   # part_s
               torch.empty(b, ntiles, E, dtype=f32, device=dev)]    # part_w
    tensors = [x, bias, w["w1"], w["b1"], w["s1"], w["t1"], w["w2"], w["b2"], w["s2"],
               w["t2"], w["w3"], w["b3"], w["s3"], w["t3"], wab, bab, w["wc"], w["bc"],
               w["wt"], w["bt"], pooled, m, s, tok, l, *(saved[k] for k in SAVED), *scratch]
    dims, scales = _dims((b, t, d_in, hd, nh, e, f, dout), seed, row_offset, pre_rate,
                         gate_rate)
    err = _call(lib.encoder_train_forward, tensors, dims, scales, dev)
    if err != 0:
        raise RuntimeError(f"encoder_train_fwd kernel launch failed: cudaError {err}")
    fwd_launches += 1
    return pooled, m, s, tok, l, saved


@torch.no_grad()
def encoder_train_bwd_cuda(x, l, m, s, g, inner, dtok, saved, w, seed: int,
                           row_offset: int = 0, pre_rate: float = PRE_RATE,
                           gate_rate: float = GATE_RATE,
                           need_dx: bool = False) -> Dict[str, torch.Tensor]:
    """Launch K7 on CUDA tensors; returns as `encoder_train_bwd_plain`."""
    global bwd_launches
    b, t, d_in, hd, nh, e, f, dout = _check_shapes(x, w, "encoder_train_bwd")
    dev, f32, bf = x.device, torch.float32, torch.bfloat16
    M, E = b * t, nh * e
    kname = "encoder_train_bwd"
    for name, ten, shape, dtype in (("l", l, (b, t, nh), f32), ("m", m, (b, nh), f32),
                                    ("s", s, (b, nh), f32), ("g", g, (b, E), f32),
                                    ("inner", inner, (b, nh), f32),
                                    ("dtok", dtok, (b, t, dout), bf),
                                    ("u1", saved["u1"], (b, t, hd), bf),
                                    ("u2", saved["u2"], (b, t, hd), bf),
                                    ("u3", saved["u3"], (b, t, E), bf),
                                    ("ap", saved["ap"], (b, t, nh * f), bf),
                                    ("bp", saved["bp"], (b, t, nh * f), bf),
                                    ("rstd", saved["rstd"], (b, t, 3), f32)):
        _build.check_operand(kname, name, ten, shape, dtype, dev)
    lib = _build.load(kname)
    dims, scales = _dims((b, t, d_in, hd, nh, e, f, dout), seed, row_offset, pre_rate,
                         gate_rate)
    ws = (ctypes.c_longlong * 2)()
    lib.encoder_train_bwd_workspace.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.encoder_train_bwd_workspace.restype = None
    lib.encoder_train_bwd_workspace(dims, ws)
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
    tensors = [x, l, m, s, g, inner, dtok, *(saved[k] for k in SAVED),
               w["w1"], w["s1"], w["t1"], w["w2"], w["s2"], w["t2"], w["w3"], w["s3"],
               w["t3"], wab, w["wc"], w["wt"], *out.values(), *scratch, dx]
    err = _call(lib.encoder_train_backward, tensors, dims, scales, dev)
    if err != 0:
        raise RuntimeError(f"encoder_train_bwd kernel launch failed: cudaError {err}")
    bwd_launches += 1
    wab_g, bab_g = out.pop("wab"), out.pop("bab")
    out.update(wa=wab_g[:, :f], wb=wab_g[:, f:], ba=bab_g[:, 0], bb=bab_g[:, 1])
    if need_dx:
        out["x"] = dx
    return out


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

class EncoderTrain(torch.autograd.Function):
    """(x, bias, seed, row_offset, pre_rate, gate_rate, need_dx, *operands in
    W_KEYS order) -> (pooled [b, nh, e] in x.dtype, tok [b, t, d_out]). x
    gets a gradient only with need_dx (the input carries a learned
    component: the stain-encoding columns)."""

    @staticmethod
    def forward(ctx, x, bias, seed, row_offset, pre_rate, gate_rate, need_dx, *ws):
        w = dict(zip(W_KEYS, ws))
        fwd = encoder_train_fwd_cuda if x.is_cuda else encoder_train_fwd_plain
        pooled32, m, s, tok, l, saved = fwd(x, bias, w, seed, row_offset, pre_rate, gate_rate)
        ctx.args = (seed, row_offset, pre_rate, gate_rate)
        ctx.need_dx = need_dx
        ctx.save_for_backward(x, l, m, s, pooled32, *(saved[k] for k in SAVED), *ws)
        nh, _, e = w["wa"].shape
        return pooled32.to(x.dtype).reshape(x.shape[0], nh, e), tok

    @staticmethod
    def backward(ctx, dpooled, dtok):
        x, l, m, s, pooled32, *rest = ctx.saved_tensors
        saved = dict(zip(SAVED, rest[:len(SAVED)]))
        w = dict(zip(W_KEYS, rest[len(SAVED):]))
        b, t, _ = x.shape
        nh, _, e = w["wa"].shape
        dout = w["wt"].shape[0]
        g = (torch.zeros(b, nh * e, dtype=torch.float32, device=x.device) if dpooled is None
             else dpooled.float().reshape(b, nh * e).contiguous())
        inner = (g * pooled32).reshape(b, nh, e).sum(-1)             # encoder_train.py:657-659
        dtok = (torch.zeros(b, t, dout, dtype=x.dtype, device=x.device) if dtok is None
                else dtok.to(x.dtype).contiguous())
        bwd = encoder_train_bwd_cuda if x.is_cuda else encoder_train_bwd_plain
        grads = bwd(x, l, m, s, g, inner, dtok, saved, w, *ctx.args, need_dx=ctx.need_dx)
        return (grads.get("x"),) + (None,) * 6 + tuple(grads[k].to(w[k].dtype)
                                                        for k in W_KEYS)


def token_mask_bias(mask, b: int, t: int, device) -> torch.Tensor:
    """[b, t] f32 logit bias: 0 on valid tokens, NEG_INF on padding."""
    return mask_bias(mask, b, t, 1, torch.device(device)).reshape(b, t)


def encoder_train(x: torch.Tensor, mask, w: Dict[str, torch.Tensor], seed: int,
                  pre_rate: Optional[float] = None, gate_rate: Optional[float] = None,
                  row_offset: int = 0, need_dx: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused training-mode encoder (ref semantics Model.py:110-146 +
    Model.py:350-417 + abmil.py:34-63). x [b, t, d_in] in the compute dtype,
    mask [b, t] bool or None, w: `train_operands` (the gradients flow back
    through them), seed: int. A rate left None is this module's PRE_RATE /
    GATE_RATE, read at call time. need_dx: x gets a gradient (JAX's static
    need_dx, madeleine.py:204). Returns (pooled [b, nh, e], tok [b, t,
    d_out]), both in x.dtype."""
    b, t, _ = x.shape
    pre_rate = PRE_RATE if pre_rate is None else pre_rate
    gate_rate = GATE_RATE if gate_rate is None else gate_rate
    bias = token_mask_bias(mask, b, t, x.device)
    return EncoderTrain.apply(x.contiguous(), bias, int(seed), int(row_offset),
                              float(pre_rate), float(gate_rate), bool(need_dx),
                              *(w[k] for k in W_KEYS))
