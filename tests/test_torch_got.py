"""The port's GOT loss (madeleine_torch/ops/losses.py: cosine_cost, the
threshold-ReLU, got_loss, got_loss_multi) and the GOT branch of
compute_losses against the golden fixture and the JAX package, f32 on the
CPU. The JAX side runs its unfused glue route (MADELEINE_NO_GOT_GLUE=1),
the route the port takes; its IPOT and GW loops are the XLA loops there."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madeleine_tpu.ops import losses as JL
from madeleine_tpu.train import trainer as jax_trainer
from madeleine_torch.ops import losses as L
from madeleine_torch.train.trainer import compute_losses, got_generator, got_gumbel
from tests.torch_port_helpers import GOLDEN_DIR, configs, to_torch

VALUE_RTOL = 1e-4
# gradients: the IPOT adjoint of 30 iterations sums many f32 terms in another
# order than XLA, so relative 1e-3 and absolute 1e-4 x the largest gradient
GRAD_RTOL, GRAD_ATOL_SCALE = 1e-3, 1e-4


@pytest.fixture
def unfused_glue(monkeypatch):
    monkeypatch.setenv("MADELEINE_NO_GOT_GLUE", "1")


def _tokens(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _assert_grads(got, want, keep=None):
    want = np.asarray(want)
    if keep is not None:
        got, want = got[keep], want[keep]
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL_SCALE * np.abs(want).max())


def test_cosine_cost_and_threshold_match_jax():
    """The reference's x / (||x|| + 1e-12) normalisation (a zero token gives
    cost 1, not a NaN) and the masked min/max threshold: 1e-6 absolute."""
    x, y = _tokens((3, 10, 8), 0), _tokens((3, 12, 8), 1)
    x[1, 4] = 0.0
    mask = np.array([True, False, True])
    want = JL._threshold_relu(JL.cosine_cost(jnp.asarray(x), jnp.asarray(y)), jnp.asarray(mask))
    got = L._threshold_relu(L.cosine_cost(to_torch(x), to_torch(y)), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    assert (L.cosine_cost(to_torch(x), to_torch(y))[1, 4] == 1.0).all()


def test_got_loss_matches_golden():
    """The reference torch GOT at its call-site iterations (30, 5 x 20):
    rtol 1e-3, atol 1e-3, the bar of tests/test_golden.py."""
    gold = np.load(os.path.join(GOLDEN_DIR, "golden.npz"))
    got = float(L.got_loss(to_torch(gold["got/v"]), to_torch(gold["got/q"])))
    np.testing.assert_allclose(got, gold["got/out"], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("masked", [False, True])
def test_got_loss_matches_jax_values_and_gradients(unfused_glue, masked):
    v, q = _tokens((4, 24, 16), 2), _tokens((4, 24, 16), 3)
    mask = np.array([True, True, False, True]) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    want, (gv, gq) = jax.value_and_grad(
        lambda a, b: JL.got_loss(a, b, sample_mask=jm), argnums=(0, 1))(jnp.asarray(v),
                                                                      jnp.asarray(q))
    tv, tq = to_torch(v).requires_grad_(True), to_torch(q).requires_grad_(True)
    got = L.got_loss(tv, tq, sample_mask=None if mask is None else torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=VALUE_RTOL)
    _assert_grads(tv.grad.numpy(), gv)
    _assert_grads(tq.grad.numpy(), gq)


def test_got_loss_subsample_is_one_shared_draw():
    """subsample < n draws one index set from the generator for both sides:
    equal to got_loss on those tokens."""
    v, q = to_torch(_tokens((2, 40, 8), 4)), to_torch(_tokens((2, 40, 8), 5))
    idx = torch.randperm(40, generator=torch.Generator().manual_seed(7))[:16]
    want = L.got_loss(v[:, idx], q[:, idx])
    got = L.got_loss(v, q, subsample=16, generator=torch.Generator().manual_seed(7))
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="generator"):
        L.got_loss(v, q, subsample=16)


def _multi_inputs(S=2, b=4, n=16, d=8, seed=6):
    v, q = _tokens((S, b, n, d), seed), _tokens((S, b, n, d), seed + 1)
    mask = np.ones((S, b), bool)
    mask[1, 2] = False
    return v, q, mask


@pytest.mark.parametrize("masked", [False, True])
def test_got_loss_multi_matches_jax(unfused_glue, masked):
    """Per-stain losses [S] (rtol 1e-4) and gradients w.r.t. v and q."""
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
    _assert_grads(tv.grad.numpy(), gv)
    _assert_grads(tq.grad.numpy(), gq)


def test_got_loss_multi_with_an_invalid_zero_sample(unfused_glue):
    """An invalid sample whose tokens are all zero (a missing stain's
    placeholder): finite per-stain values equal to JAX's, a gradient that is
    finite everywhere and exactly 0 on that sample, and the other samples'
    gradients equal to JAX's. JAX's own gradient on that sample is NaN (the
    derivative of its norm at 0, masked only after the fact); PyTorch's norm
    backward gives 0 there, which is the value that the mask means."""
    v, q, mask = _multi_inputs(seed=8)
    v[1, 2] = 0.0
    q[1, 2] = 0.0
    f = lambda a, b: JL.got_loss_multi(a, b, sample_mask=jnp.asarray(mask))
    want = np.asarray(f(jnp.asarray(v), jnp.asarray(q)))
    gv, gq = jax.grad(lambda a, b: jnp.sum(f(a, b)), argnums=(0, 1))(jnp.asarray(v),
                                                                      jnp.asarray(q))
    tv, tq = to_torch(v).requires_grad_(True), to_torch(q).requires_grad_(True)
    got = L.got_loss_multi(tv, tq, sample_mask=torch.from_numpy(mask))
    got.sum().backward()
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=VALUE_RTOL)
    for g, w in ((tv.grad, gv), (tq.grad, gq)):
        assert torch.isfinite(g).all() and not g[1, 2].any()
        _assert_grads(g.numpy(), w, keep=mask)


def test_got_loss_multi_equals_separate_calls():
    """One batched call equals S got_loss calls (thresholds per stain pair)."""
    v, q, mask = _multi_inputs(S=3, b=3, seed=10)
    tm = torch.from_numpy(mask)
    multi = L.got_loss_multi(to_torch(v), to_torch(q), sample_mask=tm)
    single = torch.stack([L.got_loss(to_torch(v[s]), to_torch(q[s]), sample_mask=tm[s])
                          for s in range(3)])
    torch.testing.assert_close(multi, single, rtol=1e-5, atol=1e-6)


def _loss_inputs(bs=5, n_mod=3, t=12, seed=11):
    rng = np.random.default_rng(seed)
    slide = rng.standard_normal((bs, n_mod, 1, 16)).astype(np.float32)
    tok = rng.standard_normal((bs, n_mod, t, 8)).astype(np.float32)
    labels = np.ones((bs, n_mod), np.float32)
    labels[1, 2] = 0.0
    return slide, tok, labels, np.ones(bs, bool)


@pytest.mark.parametrize("local_only", [False, True])
def test_compute_losses_got_matches_jax_with_injected_indices(unfused_glue, local_only):
    """compute_losses with local_loss="got" (and InfoNCE, or GOT alone) at
    got_subsample 8 < t, fed the indices that JAX's compute_losses draws from
    its key: the total (rtol 1e-4) and its gradients w.r.t. the slide and
    token embeddings."""
    slide, tok, labels, smask = _loss_inputs()
    jcfg, pcfg = configs(local_loss="got", got_subsample=8, temperature=0.1,
                         global_loss="-1" if local_only else "info-nce")
    key = jax.random.PRNGKey(5)
    t = tok.shape[2]
    got_rngs = jax.random.split(key, 3)
    idx = [np.array(jax.random.permutation(jax.random.split(got_rngs[s])[0], t)[:8])
           for s in (1, 2)]

    def jloss(sl, tk):
        return jax_trainer.compute_losses(jcfg, sl, tk, jnp.asarray(labels), jnp.asarray(smask),
                                          key)[0]

    want, (gs, gt) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(slide),
                                                                jnp.asarray(tok))
    ts, tt = to_torch(slide).requires_grad_(True), to_torch(tok).requires_grad_(True)
    total, flag, metrics = compute_losses(pcfg, ts, tt, torch.from_numpy(labels),
                                          torch.from_numpy(smask),
                                          got_indices=[torch.from_numpy(i) for i in idx])
    total.backward()
    assert bool(flag) and int(metrics["n_PGR"]) == 4
    np.testing.assert_allclose(float(total), float(want), rtol=VALUE_RTOL)
    _assert_grads(tt.grad.numpy(), gt)
    if not local_only:
        _assert_grads(ts.grad.numpy(), gs)


def test_compute_losses_draws_from_the_generator_and_refuses_token_masks():
    """Without indices, each stain pair draws its own index set from the
    generator: the same seed gives the same loss; GOT needs a generator or
    indices. With a token mask (a ragged batch) each side draws from its
    own valid tokens on Gumbel noise keyed by the step's seed: the same
    seed gives the same loss, the noise handed over gives the seed's loss,
    another seed another; it needs a seed or the noise."""
    slide, tok, labels, smask = _loss_inputs()
    _, pcfg = configs(local_loss="got", got_subsample=6, temperature=0.1)
    args = (pcfg, to_torch(slide), to_torch(tok), torch.from_numpy(labels),
            torch.from_numpy(smask))
    a = compute_losses(*args, generator=got_generator(3, "cpu"))[0]
    b = compute_losses(*args, generator=got_generator(3, "cpu"))[0]
    c = compute_losses(*args, generator=got_generator(4, "cpu"))[0]
    assert torch.equal(a, b) and not torch.equal(a, c)
    g = got_generator(3, "cpu")
    idx = [torch.randperm(12, generator=g)[:6] for _ in range(2)]
    assert not torch.equal(idx[0], idx[1])
    assert torch.equal(compute_losses(*args, got_indices=idx)[0], a)
    with pytest.raises(ValueError, match="generator"):
        compute_losses(*args)
    tm = torch.arange(12)[None, None, :] < torch.tensor([[[12], [9], [4]]])
    tm = tm.expand(5, 3, 12)
    r = compute_losses(*args, token_mask=tm, seed=3)[0]
    assert torch.isfinite(r) and torch.equal(r, compute_losses(*args, token_mask=tm, seed=3)[0])
    assert torch.equal(r, compute_losses(*args, token_mask=tm,
                                         gumbel=got_gumbel(3, 3, 5, 12, "cpu"))[0])
    assert not torch.equal(r, compute_losses(*args, token_mask=tm, seed=4)[0])
    with pytest.raises(ValueError, match="seed"):
        compute_losses(*args, generator=g, token_mask=tm)
