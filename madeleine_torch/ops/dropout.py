"""Standalone inverted dropout with the mask regenerated in the backward:
row 21, csrc/dropout.cu.

Replaces `madeleine_tpu/ops/dropout.py` (`_dropout_kernel`,
`hardware_dropout`, `dropout`). Over x viewed as [m, n] (the last dim is n),
each site is kept with probability 1 - thr / 2**32 and scaled by the keep
scale of the integer threshold (`prng.threshold`, so E[mask] = 1 at any
rate), in f32, cast back to x's dtype. The bits are Philox4x32-10's at
counter (column // 4, 0, row_offset + row, stream), key (seed, 0), with
stream `prng.dropout_stream(site)`: a mask depends on the global row and
not on how the rows are split, and never meets the encoder's streams. The
backward runs the same mask over the cotangent and saves nothing.

The TPU kernel reseeds its hardware RNG per block and draws 8, 16 or 31
threshold bits by block shape (prng_mask.py:30-47); the port always uses 32
(ROADMAP.md C). A CPU tensor takes the plain version `dropout_plain`, which
draws the same bits through `prng.keep_mask`; a CUDA tensor launches the
kernel, bf16 or f32, or raises.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from madeleine_torch.ops import _build, prng

launches = 0   # row 21 launches (forward and backward, one per wrapper call on a CUDA tensor)


def _rows(x: torch.Tensor):
    shape = x.shape
    n = shape[-1] if shape else 1
    return (x.numel() // n if n else 0), n


def dropout_plain(x: torch.Tensor, seed: int, rate: float, row_offset: int = 0,
                  site: int = 0) -> torch.Tensor:
    """The kernel's function in PyTorch: x * keep over x viewed as [m, n]."""
    m, n = _rows(x)
    rows = torch.arange(m, device=x.device) + row_offset
    ncols = -(-n // 4) * 4
    keep = prng.keep_mask(seed, rows, torch.zeros_like(rows), prng.dropout_stream(site), ncols,
                          rate)[:, :n]
    return (x.reshape(m, n).float() * keep).to(x.dtype).reshape(x.shape)


@functools.lru_cache(maxsize=64)
def _site_args(rate: float, site: int) -> Tuple[int, float, int]:
    """(integer threshold, keep scale, Philox stream) of a (rate, site)."""
    thr, scale = prng.threshold(rate)
    return thr, scale, prng.dropout_stream(site)


def dropout_cuda(x: torch.Tensor, seed: int, rate: float, row_offset: int = 0,
                 site: int = 0) -> torch.Tensor:
    """Launch row 21 on a CUDA tensor (rate > 0); returns as `dropout_plain`.
    The heads launch it on tensors of a few hundred KB, where the host path
    is the cost: the checks are the cheapest that keep the kernel safe, the
    threshold, keep scale and stream are memoised per (rate, site), and
    nothing here records autograd (the output is a fresh tensor the kernel
    writes)."""
    global launches
    if not x.is_cuda:
        raise ValueError(f"dropout kernel needs CUDA tensors, got {x.device}")
    dtype = x.dtype
    if dtype != torch.bfloat16 and dtype != torch.float32:
        raise ValueError(f"dropout kernel: x must be bf16 or f32, got {dtype}")
    if rate <= 0.0:
        raise ValueError("dropout kernel: rate must be above 0 (rate 0 is the identity)")
    m, n = _rows(x)
    if m < 1 or n < 1 or m + row_offset > 2 ** 32:
        raise ValueError(f"dropout kernel: unsupported shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("dropout kernel: x must be contiguous")
    thr, scale, stream = _site_args(rate, site)   # the scale reaches the kernel rounded to f32
    out = torch.empty_like(x)
    _build.call_ptrs("dropout", "dropout_forward", (x, out),
                     (m, n, int(dtype == torch.bfloat16), int(seed) & prng.MASK32, row_offset,
                      thr, stream), (scale,), out.device)
    launches += 1
    return out


def _apply(x, seed, rate, row_offset, site):
    fn = dropout_cuda if x.is_cuda else dropout_plain
    return fn(x.contiguous(), seed, rate, row_offset, site)


class HardwareDropout(torch.autograd.Function):
    """x -> dropout(x); the backward applies the same mask to the cotangent."""

    @staticmethod
    def forward(ctx, x, seed, rate, row_offset, site):
        ctx.args = (seed, rate, row_offset, site)
        return _apply(x, seed, rate, row_offset, site)

    @staticmethod
    def backward(ctx, g):
        return _apply(g, *ctx.args), None, None, None, None


def hardware_dropout(x: torch.Tensor, seed: int, rate: float, row_offset: int = 0,
                     site: int = 0) -> torch.Tensor:
    """Inverted dropout of x at `rate` (> 0), keyed by the seed, the global
    row (row_offset + the row of x viewed as [m, n]) and the dropout site."""
    return HardwareDropout.apply(x, int(seed), float(rate), int(row_offset), int(site))


def dropout(x: torch.Tensor, rate: float, seed: int, row_offset: Optional[int] = None,
            site: int = 0) -> torch.Tensor:
    """JAX `dropout`: x unchanged at rate <= 0, else `hardware_dropout`.
    row_offset: the global index of x's first row (None: 0); site: which
    dropout of the calling module this is (its own stream)."""
    if rate <= 0.0:
        return x
    return hardware_dropout(x, seed, rate, 0 if row_offset is None else row_offset, site)
