"""The port's GOT glue (madeleine_torch/ops/got_glue.py: threshold_build and
gw_trace, kernels K11-K14 on the card) and `got_loss_multi` on its default
route, against the JAX package's default route (madeleine_tpu/ops/got_glue.py,
whose Pallas kernels run in interpret mode on the CPU), f32 on the CPU; and
the thresholds' cotangent against finite differences in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madeleine_tpu.ops import got_glue as JG
from madeleine_tpu.ops import losses as JL
from madeleine_torch.ops import got_glue as G
from madeleine_torch.ops import losses as L
from tests.torch_port_helpers import to_torch

# threshold_build: elementwise work and short row sums
TB_VALUE = dict(rtol=1e-6, atol=1e-7)
TB_GRAD = dict(rtol=1e-5, atol=1e-6)
# gw_trace: two products and a full sum per problem
GWT_VALUE_RTOL = 1e-5
GWT_GRAD_RTOL, GWT_GRAD_ATOL_SCALE = 1e-4, 1e-6
# got_loss_multi: the bars of tests/test_torch_got.py (30 IPOT iterations)
VALUE_RTOL, GRAD_RTOL, GRAD_ATOL_SCALE = 1e-4, 1e-3, 1e-4


def _costs(b, n, m, seed):
    """Cost-like inputs in [0, 2] and per-problem thresholds that zero about
    a third of each tensor."""
    rng = np.random.default_rng(seed)
    C0 = rng.uniform(0, 2, (b, n, m)).astype(np.float32)
    Cs0 = rng.uniform(0, 2, (b, n, n)).astype(np.float32)
    Ct0 = rng.uniform(0, 2, (b, m, m)).astype(np.float32)
    thr = rng.uniform(0.4, 0.9, (b, 3)).astype(np.float32)
    return C0, Cs0, Ct0, thr


def _cotangents(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("shape", [(4, 12, 12), (3, 12, 8)])
def test_threshold_build_matches_jax(shape):
    """(C, Cs, Ct, Cst) and the VJP of all four inputs, thr included."""
    ins = _costs(*shape, seed=0)
    want, vjp = jax.vjp(JG.threshold_build, *map(jnp.asarray, ins))
    cots = _cotangents([w.shape for w in want], seed=1)
    want_grads = vjp(tuple(map(jnp.asarray, cots)))
    xs = [to_torch(x).requires_grad_(True) for x in ins]
    got = G.threshold_build(*xs)
    got_grads = torch.autograd.grad(got, xs, [to_torch(c) for c in cots])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TB_VALUE)
    for name, g, w in zip(("C0", "Cs0", "Ct0", "thr"), got_grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TB_GRAD, err_msg=name)
    assert (got[0] == 0).any() and (got[0] > 0).any()   # the thresholds cut


def _trace_inputs(b, n, m, seed):
    rng = np.random.default_rng(seed)
    Cs = rng.uniform(0, 1, (b, n, n)).astype(np.float32)
    Ct = rng.uniform(0, 1, (b, m, m)).astype(np.float32)
    Cst = rng.uniform(0, 1, (b, n, m)).astype(np.float32)
    gamma = rng.uniform(0, 1, (b, n, m)).astype(np.float32)
    gamma /= gamma.sum((1, 2), keepdims=True)
    return Cs, Ct, Cst, gamma


@pytest.mark.parametrize("shape", [(4, 12, 12), (3, 12, 8)])
def test_gw_trace_matches_jax(shape):
    """The per-problem trace and the VJP of Cs, Ct and Cst; gamma gets none."""
    ins = _trace_inputs(*shape, seed=2)
    want, vjp = jax.vjp(JG.gw_trace, *map(jnp.asarray, ins))
    dout = np.random.default_rng(3).standard_normal(shape[0]).astype(np.float32)
    want_grads = vjp(jnp.asarray(dout))[:3]
    xs = [to_torch(x).requires_grad_(True) for x in ins]
    got = G.gw_trace(*xs)
    got_grads = torch.autograd.grad(got, xs[:3], to_torch(dout))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=GWT_VALUE_RTOL)
    for name, g, w in zip(("Cs", "Ct", "Cst"), got_grads, want_grads):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=GWT_GRAD_RTOL,
                                   atol=GWT_GRAD_ATOL_SCALE * np.abs(w).max(), err_msg=name)
    assert torch.autograd.grad(got.sum(), xs[3], allow_unused=True)[0] is None


def test_glue_gradients_match_finite_differences():
    """The autograd functions in float64 against central differences, every
    input of threshold_build (the thresholds' cotangent above all) and Cs,
    Ct, Cst of gw_trace."""
    ins = [torch.from_numpy(x).double().requires_grad_(True) for x in _costs(2, 5, 4, seed=4)]
    assert torch.autograd.gradcheck(G.ThresholdBuild.apply, ins, eps=1e-6, atol=1e-7)
    Cs, Ct, Cst, gamma = (torch.from_numpy(x).double() for x in _trace_inputs(2, 5, 4, seed=5))
    assert torch.autograd.gradcheck(
        lambda a, b, c: G.GwTrace.apply(a, b, c, gamma),
        [x.requires_grad_(True) for x in (Cs, Ct, Cst)], eps=1e-6, atol=1e-7)


def _multi_inputs(S=2, b=4, n=16, d=8, seed=6):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((S, b, n, d)).astype(np.float32)
    q = rng.standard_normal((S, b, n, d)).astype(np.float32)
    mask = np.ones((S, b), bool)
    mask[1, 2] = False
    return v, q, mask


@pytest.mark.parametrize("masked", [False, True])
def test_got_loss_multi_matches_jax_default_route(monkeypatch, masked):
    """The port's default route (threshold_build + gw_trace) against the JAX
    package's default route (its fused glue, MADELEINE_NO_GOT_GLUE unset):
    per-stain losses (rtol 1e-4) and gradients w.r.t. v and q."""
    monkeypatch.delenv("MADELEINE_NO_GOT_GLUE", raising=False)
    v, q, mask = _multi_inputs()
    jm = jnp.asarray(mask) if masked else None
    f = lambda a, b: JL.got_loss_multi(a, b, sample_mask=jm)
    want = np.asarray(f(jnp.asarray(v), jnp.asarray(q)))
    gv, gq = jax.grad(lambda a, b: jnp.sum(f(a, b)), argnums=(0, 1))(jnp.asarray(v),
                                                                      jnp.asarray(q))
    tv, tq = to_torch(v).requires_grad_(True), to_torch(q).requires_grad_(True)
    got = L.got_loss_multi(tv, tq, sample_mask=torch.from_numpy(mask) if masked else None)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=VALUE_RTOL)
    for g, w in ((tv.grad, gv), (tq.grad, gq)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_SCALE * np.abs(w).max())
    if masked:   # the invalid sample's loss is zeroed after the kernels: no gradient
        assert not tv.grad[1, 2].any() and not tq.grad[1, 2].any()


def test_got_loss_multi_goes_through_the_glue_functions(monkeypatch):
    """got_loss_multi calls threshold_build once with thr [S*b, 3] (so the
    thresholds' cotangent reaches amin/amax) and gw_trace once."""
    calls = []
    for name in ("threshold_build", "gw_trace"):
        fn = getattr(L, name)
        monkeypatch.setattr(L, name, lambda *a, _fn=fn, _n=name: calls.append(
            (_n, [tuple(x.shape) for x in a])) or _fn(*a))
    v, q, mask = _multi_inputs(S=2, b=3, n=10, seed=9)
    L.got_loss_multi(to_torch(v), to_torch(q), sample_mask=torch.from_numpy(mask))
    assert [c[0] for c in calls] == ["threshold_build", "gw_trace"]
    assert calls[0][1] == [(6, 10, 10)] * 3 + [(6, 3)]
