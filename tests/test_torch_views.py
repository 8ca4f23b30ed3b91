"""n_views=3, the intra-modality loss's half-bag views: the port's train op
with a half split (madeleine_torch/ops/encoder_train.py, the plain versions
of K6/K7's view route), the per-op lane's views
(models/abmil.py::abmil_embed_train), `make_intra_loss`, and two f32 train
steps with `intra_modality_loss="info-nce"`, each against the JAX package on
the CPU at dropout rates 0 (its fused op in interpret mode). The split is
handed to the port as the JAX side draws it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madeleine_tpu.models import abmil as jax_abmil
from madeleine_tpu.models import madeleine as mtm
from madeleine_tpu.ops import losses as JL
from madeleine_torch.models.abmil import abmil_embed_train
from madeleine_torch.models.madeleine import train_weights
from madeleine_torch.ops import encoder_train as et
from madeleine_torch.ops import gated_logits as gl
from madeleine_torch.ops import losses as L
from madeleine_torch.ops import preattn as pa
from madeleine_torch.train.optim import make_optimizer
from madeleine_torch.train.trainer import make_train_step
from tests.test_torch_train import STEP_CFG, _jax_run
from tests.torch_port_helpers import grads_as_state_dict, param_pair, to_torch, train_batch

B, D, NH, E = 2, 128, 2, 128
T_BLOCK = 32
SEED = 7
FWD = dict(rtol=1e-5, atol=1e-5)   # tests/test_encoder_train.py::test_multiview_forward_and_grads
TOL = dict(rtol=1e-4, atol=1e-5)   # the per-op lane's bars (tests/test_torch_perop_train.py)


@pytest.fixture(scope="module")
def setup():
    _, _, params, model = param_pair(seed=1, patch_embedding_dim=D, wsi_encoder_hidden_dim=E,
                                     n_heads=NH, attention_hidden_dim=E)
    return params, model


@pytest.fixture
def rates_zero(monkeypatch):
    """Both packages' per-op dropout rates and the port's train-op rates set
    to 0 (each reads them at call or trace time)."""
    monkeypatch.setattr(jax_abmil, "PRE_ATTN_DROPOUT", 0.0)
    monkeypatch.setattr(jax_abmil, "ATTN_DROPOUT", 0.0)
    monkeypatch.setattr(pa, "RATE", 0.0)
    monkeypatch.setattr(gl, "RATE", 0.0)
    monkeypatch.setattr(et, "PRE_RATE", 0.0)
    monkeypatch.setattr(et, "GATE_RATE", 0.0)


def _inputs(t, masked, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, t, D)).astype(np.float32)
    mask = rng.random((B, t)) < 0.8 if masked else None
    half = np.zeros(t, bool)
    half[rng.permutation(t)[:t // 2]] = True
    return x, mask, half


def _loss_jax(pooled, tok, views=(0, 1, 2)):
    return jnp.sum(jnp.sin(pooled[:, list(views)])) + jnp.sum(jnp.cos(tok) * 0.01)


def _loss_torch(pooled, tok, views=(0, 1, 2)):
    return torch.sin(pooled[:, list(views)]).sum() + (torch.cos(tok) * 0.01).sum()


def _jax_op(params, x, mask, half, views=(0, 1, 2)):
    """JAX's fused op (interpret mode) with the half split: (pooled, tok,
    gradients as a port state dict, dx)."""
    from madeleine_tpu.ops.encoder_train import encoder_train

    def f(xx, pre, attn, tokp):
        p, tk = encoder_train(xx, pre, attn, tokp, None if mask is None else jnp.asarray(mask),
                              jnp.int32(SEED), 0.0, 0.0, T_BLOCK, True, True,
                              jnp.asarray(half))
        return _loss_jax(p, tk, views), (p, tk)

    emb = params["wsi_embedders"]
    (_, (p, tk)), grads = jax.value_and_grad(f, argnums=(0, 1, 2, 3), has_aux=True)(
        jnp.asarray(x), emb["pre_attn"], emb["attn"], params["token_projector"])
    gsd = grads_as_state_dict({"wsi_embedders": {"pre_attn": grads[1], "attn": grads[2]},
                               "token_projector": grads[3]}, params)
    return np.asarray(p), np.asarray(tk), gsd, np.asarray(grads[0])


def _port_op(model, x, mask, half, views=(0, 1, 2)):
    model.zero_grad()
    xt = to_torch(x).requires_grad_(True)
    w = train_weights(model, torch.float32)
    pooled, tok = et.encoder_train(xt, None if mask is None else torch.from_numpy(mask), w,
                                   SEED, 0.0, 0.0, need_dx=True,
                                   half_mask=torch.from_numpy(half))
    _loss_torch(pooled, tok, views).backward()
    grads = {k: p.grad for k, p in model.named_parameters() if p.grad is not None}
    return pooled.detach().numpy(), tok.detach().numpy(), grads, xt.grad.numpy()


def _assert_grads(got, want, got_dx, want_dx):
    """Every operand's gradient and dx at rtol 2e-4 / atol 2e-4 x the largest."""
    assert set(got) == {k for k in want if not k.startswith("projector")}
    for k, g in list(got.items()) + [("x", torch.from_numpy(got_dx))]:
        ref = want_dx if k == "x" else want[k].numpy()
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(g.numpy(), ref, rtol=2e-4, atol=2e-4 * scale, err_msg=k)


@pytest.mark.parametrize("t", [96, 41], ids=["even_t", "odd_t"])
@pytest.mark.parametrize("masked", [False, True], ids=["dense", "ragged"])
def test_view_op_matches_jax(setup, masked, t):
    """The train op with a half split against JAX's encoder_train(...,
    half_mask) in interpret mode at rates 0: pooled [b, 3, nh, e] and tok at
    rtol 1e-5 / atol 1e-5, the gradient of every operand and of x at rtol
    2e-4 / atol 2e-4 x the largest (JAX's own multi-view bars). Odd t: half 2
    holds t - t // 2 tokens."""
    params, model = setup
    x, mask, half = _inputs(t, masked)
    want_p, want_t, want_g, want_dx = _jax_op(params, x, mask, half)
    got_p, got_t, got_g, got_dx = _port_op(model, x, mask, half)
    assert got_p.shape == (B, 3, NH, E) and half.sum() == t // 2
    np.testing.assert_allclose(got_p, want_p, **FWD)
    np.testing.assert_allclose(got_t, want_t, **FWD)
    _assert_grads(got_g, want_g, got_dx, want_dx)


@pytest.mark.parametrize("case", ["t_is_1", "valid_in_one_half"])
def test_an_empty_view_pools_to_zero(setup, case):
    """A view with no unmasked token (t = 1, whose half 1 is empty; or a
    mask whose valid tokens all fall in one half) pools to 0 in the port
    (the plain pool's rule), where JAX's fused kernel pools it near-uniformly
    (encoder_train.py:231-236; ROADMAP C). The other views equal JAX's at
    the forward bar, and with the empty view left out of the loss so are the
    gradients, which are finite."""
    params, model = setup
    if case == "t_is_1":
        x, mask, half = _inputs(1, False)
        empty, live = 1, (0, 2)
    else:
        x, _, half = _inputs(40, False)
        mask = np.stack([half, np.ones(40, bool)])   # bag 0: valid tokens only in half 1
        empty, live = 2, (0, 1)
    want_p, want_t, want_g, want_dx = _jax_op(params, x, mask, half, live)
    got_p, got_t, got_g, got_dx = _port_op(model, x, mask, half, live)
    assert (got_p[0, empty] == 0).all()
    np.testing.assert_allclose(got_p[:, list(live)], want_p[:, list(live)], **FWD)
    np.testing.assert_allclose(got_t, want_t, **FWD)
    assert all(torch.isfinite(g).all() for g in got_g.values())
    _assert_grads(got_g, want_g, got_dx, want_dx)


@pytest.mark.parametrize("activation", ["softmax", "sigmoid"])
def test_perop_views_match_jax_abmil_embed(setup, rates_zero, activation):
    """The per-op lane with views (the whole bag through the activation's
    pool, each half through the training pool, softmax) against JAX's
    abmil_embed(n_views=3, train=True) at rates 0, ragged bags, with JAX's
    own split handed to the port: pooled [b, 3, nh, e] at rtol 1e-4 / atol
    1e-5, and the gradients of a loss of them at rtol 1e-4 / atol 1e-5 x
    the largest."""
    params, model = setup
    t = 33
    x, mask, _ = _inputs(t, True, seed=3)
    view_rng = jax.random.PRNGKey(11)
    perm = np.asarray(jax.random.permutation(view_rng, t))
    half = np.zeros(t, bool)
    half[perm[:t // 2]] = True      # JAX's ranks < t // 2 (abmil.py:349-352)

    def f(emb):
        pooled, _ = jax_abmil.abmil_embed(emb, jnp.asarray(x), n_heads=NH, activation=activation,
                                          mask=jnp.asarray(mask), n_views=3, view_rng=view_rng,
                                          dropout_rng=jax.random.PRNGKey(0), train=True,
                                          return_tokens=True)
        return jnp.sum(jnp.sin(pooled)), pooled

    (_, want), jg = jax.value_and_grad(f, has_aux=True)(params["wsi_embedders"])
    want_g = grads_as_state_dict({"wsi_embedders": jg}, params)
    model.zero_grad()
    w = train_weights(model, torch.float32)
    pooled, _ = abmil_embed_train(w, to_torch(x), activation=activation, seed=SEED,
                                  mask=torch.from_numpy(mask), half_mask=torch.from_numpy(half))
    torch.sin(pooled).sum().backward()
    assert pooled.shape == (B, 3, NH, E)
    np.testing.assert_allclose(pooled.detach().numpy(), np.asarray(want), **TOL)
    for k, p in model.named_parameters():
        if p.grad is None:
            assert not k.startswith("wsi_embedders"), k
            continue
        ref = want_g[k].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(np.abs(ref).max())), err_msg=k)


@pytest.mark.parametrize("mode", ["contrast", "reconstruct_avg_emb", "reconstruct_masked_emb"])
def test_make_intra_loss_matches_jax(mode):
    """make_intra_loss in each mode against JAX's: InfoNCE at the configured
    temperature (masked, symmetric) or the MSE, which ignores the mask;
    values at rtol 1e-5, gradients at rtol 1e-4 / atol 1e-5 x their scale."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((10, 16)).astype(np.float32)
    k = rng.standard_normal((10, 16)).astype(np.float32)
    mask = rng.random(10) < 0.7
    jf = JL.make_intra_loss(mode, 0.1)
    want, (gq, gk) = jax.value_and_grad(
        lambda a, b: jf(a, b, mask=jnp.asarray(mask), symmetric=True), argnums=(0, 1))(
        jnp.asarray(q), jnp.asarray(k))
    qt, kt = to_torch(q).requires_grad_(True), to_torch(k).requires_grad_(True)
    got = L.make_intra_loss(mode, 0.1)(qt, kt, mask=torch.from_numpy(mask), symmetric=True)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for g, w in ((qt.grad, gq), (kt.grad, gk)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5 * max(1, np.abs(w).max()))


def _jax_half(step: int, t: int) -> np.ndarray:
    """The split JAX's train step draws at rng PRNGKey(step): loss_fn splits
    (drop, loss), forward_train splits drop into (drop, view)
    (trainer.py:201, madeleine.py:147), then ranks < t // 2 (:185-192)."""
    drop_rng, _ = jax.random.split(jax.random.PRNGKey(step))
    _, view_rng = jax.random.split(drop_rng)
    perm = np.asarray(jax.random.permutation(view_rng, t))
    half = np.zeros(t, bool)
    half[perm[:t // 2]] = True
    return half


@pytest.mark.parametrize("got", [False, True], ids=["infonce", "got"])
@pytest.mark.parametrize("route", ["fused", "perop"])
def test_intra_train_steps_match_jax(monkeypatch, rates_zero, route, got):
    """Two f32 steps with intra_modality_loss="info-nce" (n_views=3) against
    JAX's make_train_step, on the fused route (JAX's fused op in interpret
    mode, MADELEINE_FORCE_FUSED=1) and the per-op one (softmax under
    MADELEINE_NO_FUSED_ENCODER on the port's side, JAX's own per-op route),
    with and without GOT (JAX's unfused glue; got_subsample = t, so that the
    token draw does not matter). Each step gets JAX's half split, rebuilt
    from its key. The bars of test_train_steps_match_jax: the loss at rtol
    1e-4; step 1's gradients at 1e-4 relative Frobenius per tensor, the
    attention_c biases (exact gradient 0) at atol 1e-4; the parameters after
    each step within 1% of the learning rate (5% with GOT, as
    test_got_train_steps_match_jax), the attention_c biases within 2.05 lr."""
    if route == "fused":
        monkeypatch.setenv("MADELEINE_FORCE_FUSED", "1")
    else:
        monkeypatch.setenv("MADELEINE_NO_FUSED_ENCODER", "1")
    monkeypatch.setenv("MADELEINE_NO_GOT_GLUE", "1")
    cfg = dict(STEP_CFG, intra_modality_loss="info-nce")
    if got:
        cfg.update(local_loss="got", got_subsample=16)
    jcfg, pcfg, params, model = param_pair(**cfg)
    batch = train_batch(np.random.default_rng(12), bs=6, n_mod=3, t=16, d=64)
    want_losses, _, want_params = _jax_run(jcfg, params, batch, 2)

    def jax_loss(p):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        drop_rng, loss_rng = jax.random.split(jax.random.PRNGKey(0))
        slide, tok = mtm.forward_train(p, jcfg, jb["feats"], n_views=3, rng=drop_rng,
                                       train=True)
        from madeleine_tpu.train import trainer as jax_trainer

        return jax_trainer.compute_losses(jcfg, slide.astype(jnp.float32), tok,
                                          jb["modality_labels"], jb["sample_mask"],
                                          loss_rng)[0]

    want_grads = grads_as_state_dict(jax.grad(jax_loss)(jax.tree_util.tree_map(jnp.asarray,
                                                                               params)), params)
    model.train()
    opt, sched = make_optimizer(pcfg, model.parameters(), steps_per_epoch=10)
    step = make_train_step(pcfg, model, opt, sched)
    lr = pcfg.lr
    noise_only = lambda k: k.endswith("attention_c.bias")
    param_bar = 0.05 if got else 0.01
    for i in range(2):
        _, metrics = step(dict(batch, half_mask=torch.from_numpy(_jax_half(i, 16))), seed=i)
        assert not metrics["skipped"]
        np.testing.assert_allclose(float(metrics["loss"]), want_losses[i], rtol=1e-4)
        if i == 0:
            for k, p in model.named_parameters():
                ref = want_grads[k]
                if not ref.any():   # the token projector when no loss reads the tokens
                    assert p.grad is None or not p.grad.any(), k
                elif noise_only(k):
                    assert float((p.grad - ref).abs().max()) <= 1e-4, k
                else:
                    err = float((p.grad - ref).norm() / ref.norm())
                    assert err < 1e-4, (k, err)
        for k, p in model.state_dict().items():
            diff = float((p - want_params[i][k]).abs().max())
            assert diff <= (2.05 if noise_only(k) else param_bar) * lr * (i + 1), (i, k, diff)
    assert step.updates == 2
