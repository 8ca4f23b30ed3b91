"""The TMA + wgmma GEMMs of csrc/gemm_wgmma.cuh (bf16) and csrc/gemm_tf32.cuh
(split-TF32, f32 operands) behind their entry points.

K6 and K7 (`ops/encoder_train.py`) and kernel 19 (`ops/linear_tok.py`) run
their products on this GEMM from their own libraries; this wrapper reaches
it directly (csrc/gemm.cu), so that it can be held against an f32 product
at every layout and epilogue those kernels use, and timed product by
product. Nothing on the model's path calls it.

Operands are 2-D bf16 tensors with unit column stride; the tensor map spans
the whole tensor. "K-major" (``mn=False``): rows are m (or n) and columns k,
as X and W of a forward product X W^T. "MN-major" (``mn=True``): rows are k
and columns m (or n), as the weights of an input gradient and both operands
of a weight gradient. Batch z's tile lies ``off=(off_mn, off_k)`` z further
along each axis.

The split-TF32 GEMM (`tf32_gemm`, `tf32_wgrad`, `tf32_split`) takes f32
operands: A K-major and B pre-split by `tf32_split` (its TF32 hi rows, then
its lo rows), as K6 / K7 with f32 operands run their forward and input
gradient products; or both token-major, as their weight gradients.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from madeleine_torch.ops import _build, prng

EPI_BF16, EPI_F32, EPI_GATES = 0, 1, 2
LAYOUTS = {(False, False): 0, (False, True): 1, (True, True): 2}

launches = 0   # launches of the bf16 GEMM through this wrapper
tf32_launches = 0   # launches of the split-TF32 GEMM through this wrapper


def _operand(name: str, x: torch.Tensor, off: Tuple[int, int], dtype=torch.bfloat16,
             rows: Optional[int] = None):
    if x.dtype != dtype or x.dim() != 2 or x.stride(1) != 1 or not x.is_cuda:
        raise ValueError(f"gemm kernel: {name} must be a 2-D {dtype} CUDA tensor with unit "
                         f"column stride, got {x.dtype} {tuple(x.shape)} strides {x.stride()} "
                         f"on {x.device}")
    _build.check_aligned("gemm", name, x)
    step = 16 // x.element_size()
    if x.stride(0) % step:
        raise ValueError(f"gemm kernel: {name}'s row stride {x.stride(0)} is no multiple of "
                         f"{step} elements (TMA reads 16-byte rows)")
    return [x.stride(0), x.shape[0] if rows is None else rows, x.shape[1], off[0], off[1]]


def wgmma_gemm(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *, a_mn: bool, b_mn: bool,
               M: int, N: int, K: int, batches: int = 1, a_off=(0, 0), b_off=(0, 0),
               ldc: Optional[int] = None, stride_c: int = 0, bias=None, stride_bias: int = 0,
               beta: bool = False, act_split: int = -1, wgrad: bool = False,
               gates: Optional[dict] = None) -> torch.Tensor:
    """c[z] (+)= epi(A_z . B_z^T + bias_z) on c's device's current stream.

    c: the output, bf16 (EPI_BF16) or f32, element (z, r, col) at
    z * stride_c + r * ldc + col of its storage. wgrad: both operands
    MN-major, c [batches, M, N] f32, split over K as K7 splits its weight
    gradients. gates: K6's gate epilogue (both operands K-major, N = 2f):
    a dict of ap, bp [M, nh f] bf16, lpart [M, nh, f / 64] f32, wc [nh, f]
    f32, t, row_offset, seed and rate; c is then unused (pass lpart)."""
    global launches
    layout = LAYOUTS.get((bool(a_mn), bool(b_mn)))
    if layout is None:
        raise ValueError("gemm kernel: an MN-major A needs an MN-major B")
    dims_a, dims_b = _operand("a", a, a_off), _operand("b", b, b_off)
    if c.dtype not in (torch.bfloat16, torch.float32) or c.device != a.device \
            or b.device != a.device:
        raise ValueError(f"gemm kernel: c must be a bf16 or f32 tensor on {a.device}")
    epi = EPI_GATES if gates else EPI_BF16 if c.dtype == torch.bfloat16 else EPI_F32
    ptrs = [a, b, c, bias, None, None, None, None, None]
    scale, extra = 1.0, [0, 0, 0, 0, 0]
    if gates:
        f = gates["wc"].shape[1]
        ptrs[4:8] = gates["ap"], gates["bp"], gates["lpart"], gates["wc"]
        dims_d, (scale,) = prng.kernel_args((), gates["seed"], gates["row_offset"], gates["rate"])
        seed, row_offset, thr = dims_d
        extra = [f, gates["t"], row_offset, seed, thr]
    if wgrad:
        work = _build.entry("gemm", "gemm_wgmma_wgrad_work", [ctypes.c_longlong] * 4,
                            ctypes.c_longlong)(M, N, K, batches)
        ptrs[8] = torch.empty(max(work, 1), dtype=torch.float32, device=c.device)
    dims = [layout, epi, int(wgrad), M, N, K, batches, int(beta), act_split, *dims_a, *dims_b,
            N if ldc is None else ldc, stride_c, stride_bias, *extra]
    _build.call_ptrs("gemm", "gemm_wgmma_run", ptrs, dims, (scale,), c.device)
    launches += 1
    return c



def tf32_split(w: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """w [batches, R, C] (or [R, C]) f32 on the card split into TF32 hi and lo
    (csrc/gemm_tf32.cuh::split_weights): [2 batches R, C] (transpose: [2
    batches C, R]), the hi rows, then the lo rows."""
    w3 = w.reshape(-1, *w.shape[-2:]).contiguous()
    nb, R, C = w3.shape
    out = torch.empty(2 * nb * (C if transpose else R), R if transpose else C,
                      dtype=torch.float32, device=w.device)
    _build.call_ptrs("gemm", "gemm_tf32_split", [w3, out], [nb, R, C, int(transpose)], (),
                     w.device)
    return out


def tf32_gemm(a: torch.Tensor, b_split: torch.Tensor, c: torch.Tensor, *, M: int, N: int,
              K: int, batches: int = 1, a_off=(0, 0), b_off=(0, 0), ldc: Optional[int] = None,
              stride_c: int = 0, bias=None, stride_bias: int = 0,
              beta: bool = False) -> torch.Tensor:
    """c[z] (+)= A_z . B_z^T + bias_z in f32 on the split-TF32 GEMM: a K-major
    f32, b_split from `tf32_split` (its first half the hi rows), c f32,
    element (z, r, col) at z * stride_c + r * ldc + col."""
    global tf32_launches
    dims_a = _operand("a", a, a_off, torch.float32)
    dims_b = _operand("b", b_split, b_off, torch.float32, rows=b_split.shape[0] // 2)
    if c.dtype != torch.float32 or c.device != a.device:
        raise ValueError(f"gemm kernel: c must be an f32 tensor on {a.device}")
    dims = [0, M, N, K, batches, int(beta), *dims_a, *dims_b, N if ldc is None else ldc,
            stride_c, stride_bias]
    _build.call_ptrs("gemm", "gemm_tf32_run", [a, b_split, c, bias, None], dims, (), c.device)
    tf32_launches += 1
    return c


def tf32_wgrad(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *, M: int, N: int, K: int,
               batches: int = 1) -> torch.Tensor:
    """c [batches, M, N] = sum over the K tokens of A(tok, m) B(tok, n) on the
    split-TF32 GEMM: a [K, batches M], b [K, batches N] f32 token-major (batch
    z's columns at z M, z N), split over the tokens as K7 with f32 operands
    splits its weight gradients."""
    global tf32_launches
    dims_a = _operand("a", a, (M, 0), torch.float32)
    dims_b = _operand("b", b, (N, 0), torch.float32)
    work = _build.entry("gemm", "gemm_tf32_wgrad_work", [ctypes.c_longlong] * 4,
                        ctypes.c_longlong)(M, N, K, batches)
    ws = torch.empty(max(work, 1), dtype=torch.float32, device=c.device)
    dims = [1, M, N, K, batches, 0, *dims_a, *dims_b, N, M * N, 0]
    _build.call_ptrs("gemm", "gemm_tf32_run", [a, b, c, None, ws], dims, (), c.device)
    tf32_launches += 1
    return c
