"""K13, the GW trace's forward, on the card-wide f32 tile product
(madeleine_torch/csrc/gemm_f32.cuh, gwt_fwd_tiles_kernel in
madeleine_torch/csrc/got_glue.cu), checked here without the card:

- the tile plan the wrapper passes to the kernel (`gwt_fwd_plan`) and the
  tasks the kernel decodes from it (`_tasks`, a mirror) cover every output of
  both [n, m] products exactly once, at the train step's shape, an odd one
  and a ragged one (n = 100, m = 320: partial tiles on both sides);
- a plain mirror of the kernel's sum order (each thread its 64 outputs in
  the engine's order, a warp butterfly, the warps in order, then the tiles
  of a problem in order) against `gw_trace_plain` in float64 at 1e-6 and
  against JAX's interpret-mode `_gwt_fwd_call` in float32 at 1e-5; a control
  that drops one tile's partial must miss the float64 bar;
- the wrappers refuse CPU tensors and count no launch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madeleine_tpu.ops.got_glue import _gwt_fwd_call
from madeleine_torch.ops import got_glue as G

SHAPES = {"step": (260, 256, 256), "odd": (7, 256, 192), "ragged": (5, 100, 320)}
# the step's [n, m] at fewer problems: the mirror's float64 products stay quick
MIRROR_SHAPES = {"step": (3, 256, 256), "odd": (7, 256, 192), "ragged": (5, 100, 320)}
TILE, THREADS = 128, 256   # csrc/gemm_f32.cuh TILE, THREADS


def _tasks(b, n, m):
    """Every tile task of one K13 phase in launch order, (problem, i0, j0),
    decoded from the block index x as gwt_fwd_tiles_kernel decodes it from
    the plan: problem x // per, tile x % per, row by row."""
    ti, tj = G.gwt_fwd_plan(n, m)
    per = ti * tj
    return [(x // per, (x % per // tj) * TILE, (x % per % tj) * TILE) for x in range(b * per)]


@pytest.mark.parametrize("label", list(SHAPES))
def test_tile_plan_covers_every_output_once(label):
    """Every element of t1 = Cs gamma [n, m] and of t1 Ct^T [n, m] of every
    problem lies in exactly one task's tile (both phases launch the same
    plan), and no task's tile lies wholly outside the product."""
    b, n, m = SHAPES[label]
    cover = np.zeros((b, n, m), np.uint8)
    tasks = _tasks(b, n, m)
    for p, i0, j0 in tasks:
        assert i0 < n and j0 < m
        cover[p, i0:i0 + TILE, j0:j0 + TILE] += 1
    assert (cover == 1).all()
    t = lambda x: -(-x // TILE)
    assert len(tasks) == b * t(n) * t(m)


def test_tile_plan_is_the_kernels_check():
    """csrc/got_glue.cu::gw_trace_forward refuses any plan but (tiles(n),
    tiles(m)) of 128 x 128 tiles. At the step's shape that is 1,040 tasks
    per phase."""
    t = lambda x: -(-x // TILE)
    for n, m in ((256, 256), (256, 192), (100, 320), (1, 1), (129, 127)):
        assert G.gwt_fwd_plan(n, m) == (t(n), t(m))
    assert len(_tasks(*SHAPES["step"])) == 1040


def _mirror(q, drop=None):
    """The kernel's sum of q = (Cst - 2 t1 Ct^T) o gamma [b, n, m], in its
    order and q's dtype: per tile, thread (ty, tx) adds its rows 64 a + 4 ty +
    rr and columns 64 h + 4 tx + c in the order (a, rr, h, c); a warp adds
    its lanes by a butterfly over offsets 16 .. 1 and the block its 8 warps in
    order; each problem adds its tiles in plan order. Outputs beyond n or m
    are never added (here: padded with exact zeros, which add nothing).
    drop: a tile index whose partial is left out (the control)."""
    b, n, m = q.shape
    ti, tj = G.gwt_fwd_plan(n, m)
    pad = torch.zeros(b, ti * TILE, tj * TILE, dtype=q.dtype)
    pad[:, :n, :m] = q
    # [b, ti, a, ty, rr, tj, h, tx, c] -> [b, ti, tj, ty, tx, (a, rr, h, c)]
    v = pad.reshape(b, ti, 2, 16, 4, tj, 2, 16, 4).permute(0, 1, 5, 3, 7, 2, 4, 6, 8)
    v = v.reshape(b, ti * tj, THREADS, 64)
    s = torch.zeros(b, ti * tj, THREADS, dtype=q.dtype)
    for k in range(64):
        s = s + v[..., k]
    lanes = s.reshape(b, ti * tj, THREADS // 32, 32)
    idx = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., idx ^ o]
    part = torch.zeros(b, ti * tj, dtype=q.dtype)
    for w in range(THREADS // 32):
        part = part + lanes[..., w, 0]
    out = torch.zeros(b, dtype=q.dtype)
    for tile in range(ti * tj):
        if tile != drop:
            out = out + part[:, tile]
    return out


def _inputs(b, n, m, seed):
    """Thresholded-cost-like operands: non-negative Cs, Ct, Cst and a plan
    gamma that sums to 1 per problem."""
    rng = np.random.default_rng(seed)
    Cs = rng.uniform(0, 1, (b, n, n)).astype(np.float32)
    Ct = rng.uniform(0, 1, (b, m, m)).astype(np.float32)
    Cst = rng.uniform(0, 2, (b, n, m)).astype(np.float32)
    gamma = rng.uniform(0, 1, (b, n, m)).astype(np.float32)
    gamma /= gamma.sum((1, 2), keepdims=True)
    return Cs, Ct, Cst, gamma


def _summand(Cs, Ct, Cst, gamma):
    return (Cst - 2.0 * torch.matmul(torch.matmul(Cs, gamma), Ct.transpose(1, 2))) * gamma


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("label", list(MIRROR_SHAPES))
def test_mirror_of_the_sum_order_matches_the_plain_trace(label):
    """In float64 the kernel's order gives gw_trace_plain's value to 1e-6
    relative (rounding only); leaving out one tile's partial misses that bar,
    so the mirror adds every tile."""
    b, n, m = MIRROR_SHAPES[label]
    x = [torch.from_numpy(a).double() for a in _inputs(b, n, m, seed=3)]
    want = G.gw_trace_plain(*x)
    got = _mirror(_summand(*x))
    assert _rel(got, want) <= 1e-6
    ti, tj = G.gwt_fwd_plan(n, m)
    assert _rel(_mirror(_summand(*x), drop=ti * tj - 1), want) > 1e-6


@pytest.mark.parametrize("label", ["odd", "ragged"])
def test_mirror_in_float32_matches_jax_interpret(label):
    """The same order in float32 against JAX's interpret-mode _gwt_fwd_call,
    1e-5 relative: K13's bar on the card."""
    b, n, m = SHAPES[label]
    arrs = _inputs(b, n, m, seed=4)
    want = np.asarray(_gwt_fwd_call(*(jnp.asarray(a) for a in arrs), interpret=True))
    got = _mirror(_summand(*(torch.from_numpy(a) for a in arrs))).numpy()
    assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)


def test_k13_wrappers_refuse_cpu_tensors_and_count_nothing():
    """Both K13 entry points raise on CPU tensors (no plain fallback) and
    leave their launch counts alone; gw_trace on CPU tensors takes the plain
    chain without counting."""
    counts = lambda: (G.gwt_fwd_launches, G.gwt_fwd_rowblock_launches)
    before = counts()
    b, n, m = 2, 8, 12
    x = [torch.rand(*s) for s in ((b, n, n), (b, m, m), (b, n, m), (b, n, m))]
    out = G.gw_trace(*x)
    torch.testing.assert_close(out, G.gw_trace_plain(*x))
    for call in (G.gw_trace_cuda, G.gw_trace_rowblock_cuda):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            call(*x)
    assert counts() == before
