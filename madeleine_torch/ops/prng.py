"""Counter-based dropout masks (Philox4x32-10), shared by the train kernels
and their plain versions.

Replaces the TPU's in-kernel hardware RNG (`madeleine_tpu/ops/prng_mask.py`,
re-seeded per block in `ops/preattn.py::_layer_mask`,
`ops/gated_logits.py::_branch_mask` and `ops/encoder_train.py::_block_seed`).
The TPU reseeds per (token block, layer or branch), so its masks depend on
the block size. Here each site draws from a counter that names it:

    key     = (seed, 0)
    counter = (column // 4, token, global row, stream)
    bits    = word (column % 4) of Philox4x32-10(counter, key)

with stream 0, 1, 2 for the three pre-attention layers and 3 + 2*h + branch
for gate branch (0 = tanh, 1 = sigmoid) of head h. A mask therefore does not
depend on how a kernel tiles the tokens, and the backward regenerates the
forward's bits. `csrc/philox.cuh` computes the same bits on the card.

Standalone dropout (ops/dropout.py, over [m, n] rows) draws with token 0 and
stream DROPOUT_STREAM0 + site, site 0, 1, ... one per dropout site of a
module (a head's layers). The encoder's streams are 0 to 2 + 2*nh with
nh <= 32 (the kernels' limit), below 2**31, so the two never draw the same
bits for one seed.

Threshold width: 32 bits. A site is kept when bits >= thr, with
thr = clamp(round(rate * 2**32), 1, 2**32 - 1), and kept sites are scaled by
1 / (1 - thr / 2**32): the scale comes from the integer threshold actually
used (prng_mask.py:44-45), so E[mask] is exactly 1 at any rate.
"""

from __future__ import annotations

from typing import Tuple

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK32 = 0xFFFFFFFF
LEVELS = 1 << 32
DROPOUT_STREAM0 = 1 << 31


def gate_stream(head: int, branch: int) -> int:
    return 3 + 2 * head + branch


def dropout_stream(site: int) -> int:
    if not 0 <= site < DROPOUT_STREAM0:
        raise ValueError(f"dropout site must be in [0, 2**31), got {site}")
    return DROPOUT_STREAM0 + site


def threshold(rate: float) -> Tuple[int, float]:
    """(integer threshold, keep scale) for a drop rate; (0, 1.0) at rate <= 0."""
    if rate <= 0.0:
        return 0, 1.0
    thr = min(max(int(round(rate * LEVELS)), 1), LEVELS - 1)
    return thr, 1.0 / (1.0 - thr / LEVELS)


def kernel_args(shape, seed: int, row_offset: int, *rates: float):
    """(dims, scales) of a train kernel's C entry point: dims = the shape
    fields, the seed, the row offset and each rate's integer threshold;
    scales = each rate's keep scale rounded to f32 (what the plain masks
    multiply by)."""
    thrs = [threshold(r) for r in rates]
    return ([*shape, int(seed) & MASK32, int(row_offset), *(t for t, _ in thrs)],
            [float(torch.tensor(sc, dtype=torch.float32)) for _, sc in thrs])


def _mulhilo(m: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of m * x for a 32-bit constant m and int64
    tensor x of 32-bit values, without leaving the int64 range."""
    lo16, hi16 = x & 0xFFFF, x >> 16
    t = lo16 * m                     # < 2**48
    u = hi16 * m                     # < 2**48
    hi = (u + (t >> 16)) >> 16
    lo = (((u & 0xFFFF) << 16) + t) & MASK32
    return hi, lo


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 on int64 tensors holding 32-bit words -> 4 words."""
    for r in range(10):
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        if r < 9:
            k0, k1 = (k0 + W0) & MASK32, (k1 + W1) & MASK32
    return c0, c1, c2, c3


def keep_mask(seed: int, rows: torch.Tensor, toks: torch.Tensor, stream: int,
              ncols: int, rate: float) -> torch.Tensor:
    """Inverted-dropout keep-scale mask f32 [*rows.shape, ncols].

    rows, toks: int tensors of one shape (global batch row and token index of
    each site row); columns are 0..ncols-1 (ncols % 4 == 0). At rate <= 0
    returns a ones tensor without drawing."""
    dev = rows.device
    if rate <= 0.0:
        return torch.ones(*rows.shape, ncols, dtype=torch.float32, device=dev)
    if ncols % 4:
        raise ValueError(f"keep_mask: ncols must be a multiple of 4, got {ncols}")
    thr, scale = threshold(rate)
    shape = (*rows.shape, ncols // 4)
    c0 = torch.arange(ncols // 4, dtype=torch.int64, device=dev).expand(shape)
    c1 = (toks.to(torch.int64) & MASK32)[..., None].expand(shape)
    c2 = (rows.to(torch.int64) & MASK32)[..., None].expand(shape)
    c3 = torch.full(shape, stream, dtype=torch.int64, device=dev)
    words = torch.stack(philox4x32(c0, c1, c2, c3, int(seed) & MASK32, 0), dim=-1)
    keep = words.reshape(*rows.shape, ncols) >= thr
    return torch.where(keep, torch.tensor(scale, dtype=torch.float32, device=dev),
                       torch.tensor(0.0, dtype=torch.float32, device=dev))


def site_rows(b: int, t: int, row_offset: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(global row, token) index tensors [b, t] of a [b, t, *] activation."""
    rows = (torch.arange(b, device=device) + row_offset)[:, None].expand(b, t)
    toks = torch.arange(t, device=device)[None, :].expand(b, t)
    return rows, toks
