"""K14, the GW trace's backward, on the card-wide f32 tile product
(madeleine_torch/csrc/gemm_f32.cuh, gwt_bwd_tiles_kernel in
madeleine_torch/csrc/got_glue.cu), checked here without the card:

- the tile plan the wrapper passes to the kernel (`gwt_bwd_plan`) and the
  tasks the kernel decodes from it (`_tasks`, a mirror) cover every output of
  the four products exactly once, at the train step's shape, an odd one and
  a ragged one (n = 100, m = 320: partial tiles on both sides);
- the stage loader's index maps (a mirror of `load_stage`) fill every slot
  of a stage once, and a K-major stage's transposing stores hit 32 banks;
- the CPU path of `gw_trace`'s backward against JAX's interpret-mode
  `_gwt_bwd_call` at the ragged shape;
- the wrappers refuse CPU tensors and count no launch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madeleine_tpu.ops.got_glue import _gwt_bwd_call
from madeleine_torch.ops import got_glue as G

SHAPES = {"step": (260, 256, 256), "odd": (7, 256, 192), "ragged": (5, 100, 320)}
TILE, BK, THREADS, LD = 128, 16, 256, 132   # csrc/gemm_f32.cuh TILE, BK, THREADS, LD
# K14's products by phase, in plan order: (name, output rows, output columns)
PRODUCTS = ((("P", "n", "m"), ("G", "m", "n")), (("dCs", "n", "n"), ("dCt", "m", "m")))


def _tasks(b, n, m):
    """Every tile task of K14 in launch order, (phase, problem, product, i0,
    j0), decoded from the block index x as gwt_bwd_tiles_kernel decodes it
    from the plan: problem x // per, task x % per (per = the phase's tiles
    per problem), the first product's tiles first, each product's row by row."""
    plan, tasks = G.gwt_bwd_plan(n, m), []
    for ph, products in enumerate(PRODUCTS):
        ai, aj, bi, bj = plan[4 * ph:4 * ph + 4]
        per = ai * aj + bi * bj
        for x in range(b * per):
            t = x % per
            first = t < ai * aj
            t = t if first else t - ai * aj
            cols = aj if first else bj
            tasks.append((ph + 1, x // per, products[0 if first else 1][0],
                          (t // cols) * TILE, (t % cols) * TILE))
    return tasks


@pytest.mark.parametrize("label", list(SHAPES))
def test_tile_plan_covers_every_output_once(label):
    """Every output element of P [n, m], G [m, n], dCs [n, n] and dCt [m, m]
    of every problem lies in exactly one task's tile, no task's tile lies
    wholly outside its product, and P and G (read by phase 2) come from
    phase 1."""
    b, n, m = SHAPES[label]
    dims = {"n": n, "m": m}
    out = {name: (dims[r], dims[c]) for phase in PRODUCTS for name, r, c in phase}
    cover = {name: np.zeros((b, *shape), np.uint8) for name, shape in out.items()}
    tasks = _tasks(b, n, m)
    for phase, p, name, i0, j0 in tasks:
        rows, cols = out[name]
        assert i0 < rows and j0 < cols
        assert (phase == 1) == (name in ("P", "G"))
        cover[name][p, i0:i0 + TILE, j0:j0 + TILE] += 1
    for name, c in cover.items():
        assert (c == 1).all(), name
    t = lambda x: -(-x // TILE)
    assert len(tasks) == b * (2 * t(n) * t(m) + t(n) ** 2 + t(m) ** 2)


def test_tile_plan_is_the_kernels_check():
    """csrc/got_glue.cu::gw_trace_backward refuses any plan but 128 x 128
    tiles covering each product: (tiles(n), tiles(m)) for P, (tiles(m),
    tiles(n)) for G, (tiles(n), tiles(n)) for dCs, (tiles(m), tiles(m)) for
    dCt. At the step's shape that is 4,160 tasks, 2,080 per launch."""
    t = lambda x: -(-x // TILE)
    dims = lambda n, m: {"n": n, "m": m}
    for n, m in ((256, 256), (256, 192), (100, 320), (1, 1), (129, 127)):
        want = tuple(t(dims(n, m)[d]) for phase in PRODUCTS for _, r, c in phase for d in (r, c))
        assert G.gwt_bwd_plan(n, m) == want == (t(n), t(m), t(m), t(n), t(n), t(n), t(m), t(m))
    assert sum(1 for task in _tasks(260, 256, 256) if task[0] == 1) == 2080


def _stage_slots(kmajor, vec):
    """(thread, [(kk, x, width)]) of one stage load, as load_stage computes them."""
    out = []
    for tid in range(THREADS):
        lane, warp, slots = tid % 32, tid // 32, []
        if kmajor:
            for q in range(TILE * BK // THREADS):
                slots.append(((lane & 7) + 8 * (q % (BK // 8)),
                              (lane >> 3) + 4 * warp + 32 * (q // (BK // 8)), 1))
        elif vec:
            for q in range(TILE * BK // (4 * THREADS)):
                e = tid + THREADS * q
                slots.append((e >> 5, (e & 31) * 4, 4))
        else:
            for q in range(TILE * BK // THREADS):
                e = tid + THREADS * q
                slots.append((e // TILE, e % TILE, 1))
        out.append(slots)
    return out


@pytest.mark.parametrize("kmajor,vec", [(True, False), (False, True), (False, False)],
                         ids=["k_major", "mn_major_16B", "mn_major_4B"])
def test_stage_loader_fills_each_slot_once(kmajor, vec):
    """Each (k, x) slot of a 16 x 128 stage is written by exactly one copy.
    A K-major operand is stored transposed, one element per copy: within
    each warp instruction the 32 stores land in 32 different banks of the
    padded stage (row pitch 132 floats), and the global reads of 8 lanes are
    32 consecutive bytes."""
    seen = np.zeros((BK, TILE), np.int32)
    slots = _stage_slots(kmajor, vec)
    for thread in slots:
        for kk, x, w in thread:
            seen[kk, x:x + w] += 1
    assert (seen == 1).all()
    if kmajor:
        for warp in range(THREADS // 32):
            for q in range(TILE * BK // THREADS):
                addr = [slots[32 * warp + lane][q] for lane in range(32)]
                assert len({(kk * LD + x) % 32 for kk, x, _ in addr}) == 32
                for g in range(4):   # lanes 8 g .. 8 g + 7: one row, 8 consecutive k
                    row = {x for _, x, _ in addr[8 * g:8 * g + 8]}
                    ks = sorted(kk for kk, _, _ in addr[8 * g:8 * g + 8])
                    assert len(row) == 1 and ks == list(range(ks[0], ks[0] + 8))


def test_gw_trace_backward_cpu_path_matches_jax_at_a_ragged_shape():
    """gw_trace_bwd_plain (the CPU path of GwTrace's backward) against JAX's
    interpret-mode _gwt_bwd_call at (5, 100, 320), elementwise rtol 1e-5:
    every product sums non-negative terms, so only rounding differs."""
    b, n, m = SHAPES["ragged"]
    rng = np.random.default_rng(11)
    Cs = rng.uniform(0, 1, (b, n, n)).astype(np.float32)
    Ct = rng.uniform(0, 1, (b, m, m)).astype(np.float32)
    Cst = rng.uniform(0, 1, (b, n, m)).astype(np.float32)
    gamma = rng.uniform(0, 1, (b, n, m)).astype(np.float32)
    gamma /= gamma.sum((1, 2), keepdims=True)
    dout = rng.standard_normal(b).astype(np.float32)
    want = _gwt_bwd_call(*(jnp.asarray(a) for a in (Cs, Ct, gamma, dout)), interpret=True)
    got = G.gw_trace_bwd_plain(*(torch.from_numpy(a) for a in (Cs, Ct, Cst, gamma, dout)))
    for name, g, w in zip(("dCs", "dCt", "dCst"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, err_msg=name)


def test_k14_wrappers_refuse_cpu_tensors_and_count_nothing():
    """Both K14 entry points raise on CPU tensors (no plain fallback) and
    leave their launch counts alone; GwTrace on CPU tensors takes the plain
    chain without counting."""
    counts = lambda: (G.gwt_bwd_launches, G.gwt_bwd_rowblock_launches)
    before = counts()
    b, n, m = 2, 8, 12
    x = [torch.rand(*s) for s in ((b, n, n), (b, m, m), (b, n, m), (b, n, m))]
    xs = [a.requires_grad_(True) for a in x[:3]]
    G.gw_trace(*xs, x[3]).sum().backward()
    for call in (G.gw_trace_bwd_cuda, G.gw_trace_bwd_rowblock_cuda):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            call(x[0].detach(), x[1].detach(), x[3], torch.ones(b))
    assert counts() == before
