"""The cluster routes of K8 (IPOT forward), K9 (IPOT backward) and K10 (the
GW gamma loop):
madeleine_torch/csrc/ipot_cluster.cuh splits each transport problem's rows
over the c blocks of a thread-block cluster, and every column sum is the
blocks' partial sums (over `cluster_rows(n, c)`) added in rank order.

A plain mirror of that summation order, for c in {1, 4, 8} and a ragged n
(slices of floor and ceil n / c rows), is held against the port's plain
versions (`ipot_plan_plain`, `ipot_plan_bwd_plain`, `gw_gamma_plain`) and
against the JAX package's Pallas kernels in interpret mode (`_fwd_call`,
`_bwd_call`, `gw_gamma_fused`) at the existing bars; K8's cluster route
deals the rows to the ranks in turn instead (`_colsum_strided`), and is
held the same way. The adjoint mirror is written
out as the kernels compute it (not autograd). Plus the route function of
each kernel at the train step's, an odd, a wide and a large shape, K8's
shared memory per block, and the anchors of the phase-breakdown tool
(madeleine_torch/tools/transport_phases.py)."""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madeleine_tpu.ops.ipot import _bwd_call, _fwd_call, gw_gamma_fused
from madeleine_tpu.ops.losses import _threshold_relu, cosine_cost
from madeleine_torch.ops import _build
from madeleine_torch.ops import ipot as I

CLUSTERS = [1, 4, 8]
SHAPES = {"square": (3, 48, 48), "ragged": (2, 37, 40)}   # 37 rows: slices of 4 and 5 at c = 8
GW_SHAPES = {"square": (3, 64, 64), "ragged": (2, 37, 64)}
GW_RTOL = 1e-4              # relative Frobenius: K10's bar (chip_smoke.py GOT_PLAN_RTOL)
MIRROR_RTOL = 1e-6          # relative Frobenius, mirror against the plain version
FWD_TOL = dict(rtol=1e-4, atol=1e-7)


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def _cost(b, n, m, seed, d=16):
    rng = np.random.default_rng(seed)
    v = jnp.asarray(rng.standard_normal((b, n, d)), jnp.float32)
    q = jnp.asarray(rng.standard_normal((b, m, d)), jnp.float32)
    return np.array(_threshold_relu(cosine_cost(v, q), None))


def _colsum(x, c):
    """Column sums of x [b, n, m] as the cluster kernels take them: each
    rank's rows summed, the c partials added in rank order."""
    parts = [x[:, r0:r1].sum(1, keepdim=True) for r0, r1 in I.cluster_rows(x.shape[1], c)]
    s = parts[0]
    for p in parts[1:]:
        s = s + p
    return s


def ipot_mirror(C, beta, iters, c, colsum=None):
    """The IPOT loop with the cluster kernels' column sums (or `colsum`)."""
    colsum = colsum or _colsum
    _, n, m = C.shape
    A = torch.exp(-C / beta)
    T = torch.ones_like(C)
    sigma = torch.full((C.shape[0], 1, m), 1.0 / m, dtype=C.dtype)
    for _ in range(iters):
        Q = A * T
        delta = 1.0 / (n * (Q * sigma).sum(2, keepdim=True))
        sigma = 1.0 / (m * colsum(Q * delta, c))
        T = delta * Q * sigma
    return T


def ipot_bwd_mirror(C, G, beta, iters, c):
    """dC as ipot_bwd.cu's cluster kernel computes it: the forward replayed
    (T_k, delta_k, sigma_k), then the adjoint recurrence, last iteration
    first, with the cluster's column sums."""
    _, n, m = C.shape
    A = torch.exp(-C / beta)
    T = torch.ones_like(C)
    sig = [torch.full((C.shape[0], 1, m), 1.0 / m, dtype=C.dtype)]
    Ts, deltas = [], []
    for _ in range(iters):
        Ts.append(T)
        Q = A * T
        delta = 1.0 / (n * (Q * sig[-1]).sum(2, keepdim=True))
        deltas.append(delta)
        sig.append(1.0 / (m * _colsum(Q * delta, c)))
        T = delta * Q * sig[-1]
    dT, dsig, dA = G, torch.zeros_like(sig[0]), torch.zeros_like(C)
    for k in range(iters - 1, -1, -1):
        Q, d, s1, s0 = A * Ts[k], deltas[k], sig[k + 1], sig[k]
        dsig1 = dsig + _colsum((d * dT) * Q, c)
        da = ((-m * s1) * s1) * dsig1
        du = ((-n * d) * d) * ((Q * (dT * s1)).sum(2, keepdim=True) + (Q * da).sum(2, keepdim=True))
        dQ = (dT * d) * s1 + d * da + du * s0
        dsig = _colsum(du * Q, c)
        dA = dA + dQ * Ts[k]
        dT = dQ * A
    return (dA * A) * (-1.0 / beta)


def gw_gamma_mirror(Cs, Ct, Cst, beta, outer, iters, c):
    _, n, m = Cst.shape
    gamma = torch.full_like(Cst, 1.0 / (n * m))
    for _ in range(outer):
        cg = Cst - 2.0 * torch.matmul(torch.matmul(Cs, gamma), Ct.transpose(1, 2))
        gamma = ipot_mirror(cg, beta, iters, c)
    return gamma


@functools.lru_cache(maxsize=None)
def _fwd_case(label):
    C = _cost(*SHAPES[label], seed=1)
    want = np.asarray(_fwd_call(jnp.asarray(C), beta=0.5, iters=30, interpret=True))
    return C, want


@functools.lru_cache(maxsize=None)
def _bwd_case(label):
    C = _cost(*SHAPES[label], seed=2)
    G = np.random.default_rng(3).standard_normal(C.shape).astype(np.float32)
    want = np.asarray(_bwd_call(jnp.asarray(C), jnp.asarray(G), beta=0.5, iters=30,
                                interpret=True))
    return C, G, want


@functools.lru_cache(maxsize=None)
def _gw_case(label):
    """tests/test_torch_ipot.py::_gw_inputs's recipe (seed 9, 32-d tokens)."""
    b, n, m = GW_SHAPES[label]
    rng = np.random.default_rng(9)
    x = jnp.asarray(rng.standard_normal((b, n, 32)), jnp.float32)
    y = jnp.asarray(rng.standard_normal((b, m, 32)), jnp.float32)
    Cs = _threshold_relu(cosine_cost(x, x), None)
    Ct = _threshold_relu(cosine_cost(y, y), None)
    cs2p = jnp.einsum("bnk,bko->bno", Cs ** 2, jnp.full((b, n, 1), 1.0 / n, jnp.float32))
    qtct2 = jnp.einsum("bko,bmk->bom", jnp.full((b, m, 1), 1.0 / m, jnp.float32), Ct ** 2)
    args = [np.array(a) for a in (Cs, Ct, cs2p + qtct2)]
    want = np.array(gw_gamma_fused(*(jnp.asarray(a) for a in args), interpret=True))
    return args, want


@pytest.mark.parametrize("n,c", [(256, 4), (256, 8), (37, 8), (7, 4), (3, 4), (5, 1)])
def test_cluster_rows_cover_the_problem_in_order(n, c):
    """Contiguous slices in rank order, floor or ceil of n / c rows each (a
    rank may own none when n < c), covering every row once."""
    rows = I.cluster_rows(n, c)
    assert len(rows) == c and rows[0][0] == 0 and rows[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
    assert {r1 - r0 for r0, r1 in rows} <= {n // c, -(-n // c)}


@pytest.mark.parametrize("label", list(SHAPES))
@pytest.mark.parametrize("c", CLUSTERS)
def test_ipot_mirror_matches_plain_and_jax(label, c):
    """The forward with the cluster's column sums against ipot_plan_plain
    (relative Frobenius 1e-6: only the order of additions differs) and
    against JAX's interpret-mode _fwd_call (rtol 1e-4, the existing bar).
    Control: a mirror that drops the last rank's partial misses 1e-6."""
    C, want = _fwd_case(label)
    Ct = torch.from_numpy(C)
    got = ipot_mirror(Ct, 0.5, 30, c)
    assert _rel(got, I.ipot_plan_plain(Ct, 0.5, 30)) <= MIRROR_RTOL
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)
    if c > 1:
        bad = ipot_mirror(Ct, 0.5, 30, c, colsum=_colsum_dropping_last)
        assert _rel(bad, I.ipot_plan_plain(Ct, 0.5, 30)) > MIRROR_RTOL


def _colsum_dropping_last(x, c):
    """A wrong combine, the control: the last rank's partial left out."""
    parts = [x[:, r0:r1].sum(1, keepdim=True) for r0, r1 in I.cluster_rows(x.shape[1], c)]
    s = parts[0]
    for p in parts[1:-1]:
        s = s + p
    return s


@pytest.mark.parametrize("label", list(SHAPES))
@pytest.mark.parametrize("c", CLUSTERS)
def test_ipot_bwd_mirror_matches_plain_and_jax(label, c):
    """The adjoint recurrence with the cluster's column sums against
    ipot_plan_bwd_plain (autograd through the plain loop; relative Frobenius
    1e-6 in float64, where only the arithmetic's order differs: in f32 the
    30-iteration adjoint's rounding alone is about 1e-6) and, in f32, against
    JAX's interpret-mode _bwd_call (rtol 1e-3, atol 1e-5 x the largest
    gradient, the existing bar)."""
    C, G, want = _bwd_case(label)
    C64, G64 = torch.from_numpy(C).double(), torch.from_numpy(G).double()
    got64 = ipot_bwd_mirror(C64, G64, 0.5, 30, c)
    assert _rel(got64, I.ipot_plan_bwd_plain(C64, G64, 0.5, 30)) <= MIRROR_RTOL
    got = ipot_bwd_mirror(torch.from_numpy(C), torch.from_numpy(G), 0.5, 30, c)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("label", list(GW_SHAPES))
@pytest.mark.parametrize("c", CLUSTERS)
def test_gw_gamma_mirror_matches_plain_and_jax(label, c):
    """The GW plan (5 outer steps of 20 iterations at beta 0.1) with the
    cluster's column sums against gw_gamma_plain (relative Frobenius 1e-6 in
    float64, where only the order of additions differs) and, in f32, against
    JAX's interpret-mode gw_gamma_fused at K10's bar, 1e-4 in relative
    Frobenius norm. beta 0.1 amplifies f32 rounding: the plain version and
    JAX's kernel differ by 4.7e-5 and 5.0e-5 on these inputs, and by 2.2e-4
    at (2, 37, 40) from the same recipe, where no f32 route holds 1e-4; the
    elementwise rtol of tests/test_torch_ipot.py sits at that floor."""
    (Cs, Ct, Cst), want = _gw_case(label)
    a64 = [torch.from_numpy(a).double() for a in (Cs, Ct, Cst)]
    got64 = gw_gamma_mirror(*a64, 0.1, 5, 20, c)
    assert _rel(got64, I.gw_gamma_plain(*a64, 0.1, 5, 20)) <= MIRROR_RTOL
    got = gw_gamma_mirror(*(torch.from_numpy(a) for a in (Cs, Ct, Cst)), 0.1, 5, 20, c)
    assert _rel(got, torch.from_numpy(want)) <= GW_RTOL


@pytest.mark.parametrize("label,n,m,bwd,gw", [
    ("step", 256, 256, ("cluster", 8), ("cluster", 4)),
    ("odd", 256, 192, ("cluster", 8), ("cluster", 4)),
    ("wide", 100, 320, ("cluster", 8), ("cluster", 4)),
    ("large", 512, 512, ("global", 1), ("global", 1)),
])
def test_transport_route_by_shape(label, n, m, bwd, gw):
    """K9 and K10 take the cluster route while a cluster's shared memory
    holds the problem's state (K10 from c = 4, K9 at c = 8), and the
    one-block global route beyond it; the choice is by shape alone."""
    assert I.transport_route("ipot_bwd", n, m) == bwd
    assert I.transport_route("gw_gamma", n, m) == gw
    for kernel, (route, c) in (("ipot_bwd", bwd), ("gw_gamma", gw)):
        if route == "cluster":
            assert I.cluster_smem_bytes(kernel, n, m, c) <= _build.SMEM_LIMIT
        else:
            assert all(I.cluster_smem_bytes(kernel, n, m, k) > _build.SMEM_LIMIT
                       for k in I.CLUSTER_SIZES[kernel])


@pytest.mark.parametrize("label,n,m,route", [
    ("step", 256, 256, ("cluster", 4)),
    ("odd", 256, 192, ("cluster", 4)),
    ("wide", 100, 320, ("cluster", 4)),
    ("large", 512, 512, ("global", 1)),
])
def test_ipot_fwd_route_by_shape(label, n, m, route):
    """K8 takes the cluster route while a cluster's shared memory holds the
    problem's A and Q, and the first design's one-block global route beyond
    it (512 x 512). Its shared memory per block is within the card's limit
    exactly when the route is the cluster route, and the route's cluster
    size is the first of CLUSTER_SIZES["ipot_fwd"] that fits."""
    assert I.transport_route("ipot_fwd", n, m) == route
    fits = [c for c in I.CLUSTER_SIZES["ipot_fwd"]
            if I.cluster_smem_bytes("ipot_fwd", n, m, c) <= _build.SMEM_LIMIT]
    assert (route[0] == "cluster") == bool(fits)
    if fits:
        assert route[1] == fits[0]


@pytest.mark.parametrize("c,want", [(4, 140544), (8, 83072)])
def test_ipot_fwd_cluster_smem_at_the_step_shape(c, want):
    """At [256, 256]: two [n / c, m] f32 slices (A and Q = A o T), delta,
    sigma and two parities of c receive slots: 137 KB at c = 4, 81 KB at
    c = 8."""
    slice_ = 256 // c * 256
    floats = 2 * slice_ + 256 // c + (1 + 2 * c) * 256
    assert I.cluster_smem_bytes("ipot_fwd", 256, 256, c) == 4 * floats == want


def _colsum_strided(x, c):
    """Column sums as K8's cluster kernel takes them: rank r owns rows
    r, r + c, ..., each column's partial summed over them in row order, the
    c partials added in rank order (at c = 4: the global route's column pass,
    whose four row groups are these ranks)."""
    n, parts = x.shape[1], []
    for r in range(c):
        acc = torch.zeros_like(x[:, :1])
        for i in range(r, n, c):
            acc = acc + x[:, i:i + 1]
        parts.append(acc)
    s = parts[0]
    for p in parts[1:]:
        s = s + p
    return s


@pytest.mark.parametrize("label", list(SHAPES))
@pytest.mark.parametrize("c", CLUSTERS)
def test_ipot_fwd_mirror_matches_plain_and_jax(label, c):
    """The forward with K8's column sums (rows dealt to the ranks in turn)
    against ipot_plan_plain (relative Frobenius 1e-6) and JAX's
    interpret-mode _fwd_call (rtol 1e-4), with the dropped-rank control."""
    C, want = _fwd_case(label)
    Ct = torch.from_numpy(C)
    got = ipot_mirror(Ct, 0.5, 30, c, colsum=_colsum_strided)
    assert _rel(got, I.ipot_plan_plain(Ct, 0.5, 30)) <= MIRROR_RTOL
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)
    if c > 1:
        drop = lambda x, c: _colsum_strided(x, c) - _colsum_strided(x[:, c - 1::c], 1)
        bad = ipot_mirror(Ct, 0.5, 30, c, colsum=drop)
        assert _rel(bad, I.ipot_plan_plain(Ct, 0.5, 30)) > MIRROR_RTOL


@pytest.mark.parametrize("source,patches", [("ipot_cluster.cuh", "HEADER_PATCHES"),
                                            ("ipot_bwd.cu", "BWD_PATCHES")])
def test_transport_phases_anchors_are_in_the_sources(source, patches):
    """madeleine_torch/tools/transport_phases.py stamps clock64() into copies
    of the cluster sources at fixed anchors: each occurs exactly once in the
    sources as they stand, so the tool's breakdown follows the kernels."""
    from madeleine_torch.tools import transport_phases as tp

    with open(os.path.join(tp.CSRC, source)) as f:
        text = f.read()
    patched = tp._patch(text, getattr(tp, patches))
    assert patched.count("PHASE(") > 0
