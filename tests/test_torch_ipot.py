"""The port's IPOT plans (madeleine_torch/ops/ipot.py: the plain versions of
kernels K8, K9 and K10, and the `IpotPlan` autograd function on CPU tensors)
against the JAX package: its XLA loop `ipot_plan`, autodiff through it, and
its Pallas kernels `_fwd_call`, `_bwd_call` and `gw_gamma_fused` run in
interpret mode, as tests/test_ipot_kernel.py runs them. f32, small shapes,
one n != m case."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madeleine_tpu.ops.ipot import _bwd_call, _fwd_call, gw_gamma_fused
from madeleine_tpu.ops.losses import _threshold_relu, cosine_cost, ipot_plan
from madeleine_torch.ops import ipot as I

FWD_TOL = dict(rtol=1e-4, atol=1e-7)
SHAPES = [(3, 48, 48), (2, 40, 56)]


def _cost(b, n, m, d=16, seed=0):
    """A cost built as the path builds it: tokens -> cosine cost -> threshold-ReLU."""
    rng = np.random.default_rng(seed)
    v = jnp.asarray(rng.standard_normal((b, n, d)), jnp.float32)
    q = jnp.asarray(rng.standard_normal((b, m, d)), jnp.float32)
    return np.array(_threshold_relu(cosine_cost(v, q), None))


@pytest.mark.parametrize("shape", SHAPES, ids=["square", "n_ne_m"])
@pytest.mark.parametrize("beta,iters", [(0.5, 30), (0.1, 20)])
def test_plain_ipot_matches_jax_loop_and_kernel(shape, beta, iters):
    C = _cost(*shape)
    got = I.ipot_plan_plain(torch.from_numpy(C), beta, iters).numpy()
    np.testing.assert_allclose(got, np.asarray(ipot_plan(jnp.asarray(C), beta, iters)),
                               **FWD_TOL)
    np.testing.assert_allclose(
        got, np.asarray(_fwd_call(jnp.asarray(C), beta=beta, iters=iters, interpret=True)),
        **FWD_TOL)
    # the autograd function's CPU route is the plain loop
    assert torch.equal(I.ipot_plan(torch.from_numpy(C), beta, iters), torch.from_numpy(got))


@pytest.mark.parametrize("shape", SHAPES, ids=["square", "n_ne_m"])
@pytest.mark.parametrize("cotangent", ["wd", "random"])
def test_ipot_plan_gradient_matches_jax(shape, cotangent):
    """dC through `IpotPlan` (CPU: autograd through the plain loop) against
    jax.grad through `ipot_plan` and against the TPU backward kernel in
    interpret mode: rtol 1e-3, atol 1e-5 x the largest gradient (the adjoint
    of 30 iterations sums many f32 terms in another order). "wd" is the
    loss's own case, sum(C o T(C)), whose explicit term T is added to the
    kernel's dC."""
    C = _cost(*shape, seed=3)
    g = (C if cotangent == "wd"
         else np.random.default_rng(4).standard_normal(C.shape).astype(np.float32))
    if cotangent == "wd":
        want = np.asarray(jax.grad(lambda c: jnp.sum(c * ipot_plan(c, 0.5, 30)))(jnp.asarray(C)))
        kernel = np.asarray(ipot_plan(jnp.asarray(C), 0.5, 30)) + np.asarray(
            _bwd_call(jnp.asarray(C), jnp.asarray(C), beta=0.5, iters=30, interpret=True))
    else:
        want = np.asarray(jax.grad(lambda c: jnp.sum(ipot_plan(c, 0.5, 30) * g))(jnp.asarray(C)))
        kernel = np.asarray(_bwd_call(jnp.asarray(C), jnp.asarray(g), beta=0.5, iters=30,
                                      interpret=True))
    Cx = torch.from_numpy(C).requires_grad_(True)
    T = I.ipot_plan(Cx, 0.5, 30)
    (Cx * T if cotangent == "wd" else T * torch.from_numpy(g)).sum().backward()
    atol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(Cx.grad.numpy(), want, rtol=1e-3, atol=atol)
    np.testing.assert_allclose(Cx.grad.numpy(), kernel, rtol=1e-3, atol=atol)


def test_plain_backward_is_autograd_through_the_plain_loop():
    C = torch.from_numpy(_cost(2, 24, 32, seed=5))
    g = torch.from_numpy(np.random.default_rng(6).standard_normal(C.shape).astype(np.float32))
    Cx = C.clone().requires_grad_(True)
    (I.ipot_plan_plain(Cx, 0.5, 12) * g).sum().backward()
    assert torch.equal(I.ipot_plan_bwd_plain(C, g, 0.5, 12), Cx.grad)


def _gw_inputs(b, n, m, seed=9, d=32):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((b, n, d)), jnp.float32)
    y = jnp.asarray(rng.standard_normal((b, m, d)), jnp.float32)
    Cs = _threshold_relu(cosine_cost(x, x), None)
    Ct = _threshold_relu(cosine_cost(y, y), None)
    cs2p = jnp.einsum("bnk,bko->bno", Cs ** 2, jnp.full((b, n, 1), 1.0 / n, jnp.float32))
    qtct2 = jnp.einsum("bko,bmk->bom", jnp.full((b, m, 1), 1.0 / m, jnp.float32), Ct ** 2)
    return [np.array(a) for a in (Cs, Ct, cs2p + qtct2)]


@pytest.mark.parametrize("shape", [(3, 64, 64), (2, 48, 64)], ids=["square", "n_ne_m"])
def test_gw_gamma_plain_matches_jax_kernel(shape):
    """The detached GW plan (5 outer steps of 20 iterations at beta 0.1)
    against `gw_gamma_fused` in interpret mode, rtol 1e-4, atol 1e-7 (the
    bar and the token width of tests/test_ipot_kernel.py). The loop at
    beta 0.1 amplifies f32 rounding: the JAX package's own XLA loop and
    kernel differ by about 5e-5 in relative Frobenius norm on such inputs,
    and so do these two, so 1e-4 is near the floor of any f32 route."""
    Cs, Ct, Cst = _gw_inputs(*shape)
    want = np.asarray(gw_gamma_fused(jnp.asarray(Cs), jnp.asarray(Ct), jnp.asarray(Cst),
                                     interpret=True))
    got = I.gw_gamma_plain(torch.from_numpy(Cs), torch.from_numpy(Ct), torch.from_numpy(Cst))
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)
    routed = I.gw_gamma(*(torch.from_numpy(a).requires_grad_(True) for a in (Cs, Ct, Cst)))
    assert torch.equal(routed, got) and not routed.requires_grad


def test_cpu_tensors_never_count_a_launch_and_kernels_refuse_them():
    """CPU tensors take the plain versions without touching a kernel count;
    a kernel wrapper given a CPU tensor raises (it never runs the plain
    version in a kernel's place)."""
    counts = lambda: (I.fwd_launches, I.bwd_launches, I.gw_launches, I.fwd_launches_global,
                      I.bwd_launches_global, I.gw_launches_global)
    before = counts()
    C = torch.from_numpy(_cost(2, 16, 16)).requires_grad_(True)
    I.ipot_plan(C, 0.5, 5).sum().backward()
    I.gw_gamma(*(torch.from_numpy(a) for a in _gw_inputs(2, 16, 16)))
    assert counts() == before
    x = C.detach()
    for call in (lambda: I.ipot_plan_cuda(x, 0.5, 5), lambda: I.ipot_plan_bwd_cuda(x, x, 0.5, 5),
                 lambda: I.gw_gamma_cuda(x, x, x, 0.1, 5, 20),
                 lambda: I._ipot_fwd_cluster(x, 0.5, 5, 4), lambda: I._ipot_fwd_global(x, 0.5, 5),
                 lambda: I._ipot_bwd_global(x, x, 0.5, 5),
                 lambda: I._gw_gamma_global(x, x, x, 0.1, 5, 20)):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            call()
