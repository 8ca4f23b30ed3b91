"""The port's training forward and train step (madeleine_torch/models/
madeleine.py::forward_train, madeleine_torch/train/) against the golden
fixtures and the JAX package, f32 on the CPU (the encoder runs the plain
versions of kernels K6/K7). The JAX step runs its fused encoder op in
interpret mode (MADELEINE_FORCE_FUSED=1, dropout rates 0 there), so both
sides run the same route at rates 0."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madeleine_tpu.models import madeleine as mtm
from madeleine_tpu.models.factory import state_dict_to_params
from madeleine_tpu.train import optim as jax_optim
from madeleine_tpu.train import trainer as jax_trainer
from madeleine_torch.models import madeleine as port
from madeleine_torch.ops import encoder_train as et
from madeleine_torch.models.factory import params_from_jax
from madeleine_torch.train.optim import make_optimizer
from madeleine_torch.train.trainer import compute_losses, make_train_step, train_loop
from tests.torch_port_helpers import (GOLDEN_DIR, flagship_model, golden_model,
                                      grads_as_state_dict, param_pair, to_torch, train_batch)

TOL = dict(rtol=1e-4, atol=1e-5)   # tests/test_golden.py's bar


@pytest.fixture
def rates_zero(monkeypatch):
    """The train op's dropout rates set to 0 (it reads them at call time)."""
    monkeypatch.setattr(et, "PRE_RATE", 0.0)
    monkeypatch.setattr(et, "GATE_RATE", 0.0)


def _fwd(model, feats, scan=True, **kw):
    model.cfg.modality_scan = scan
    with torch.no_grad():
        return port.forward_train(model, to_torch(feats), **kw)


@pytest.mark.parametrize("fixture,prefix", [("golden.npz", "train"),
                                            ("golden_flagship.npz", "fs/train")])
def test_forward_train_matches_golden_and_live_jax(rates_zero, fixture, prefix):
    """Both routes (one call per modality, and the joint call) at rates 0
    against the reference activations and the live JAX forward_train."""
    gold = np.load(os.path.join(GOLDEN_DIR, fixture))
    model = golden_model(gold) if prefix == "train" else flagship_model()
    feats = gold[f"{prefix}/in"]
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    jslide, jtok = mtm.forward_train(state_dict_to_params(sd), _jax_cfg(model.cfg),
                                     jnp.asarray(feats), n_views=1, train=False)
    for scan in (True, False):
        slide, tok = _fwd(model, feats, scan=scan)
        np.testing.assert_allclose(slide.numpy(), np.asarray(jslide), **TOL)
        np.testing.assert_allclose(tok.numpy(), np.asarray(jtok), **TOL)
        wsi, toks = port.forward_train_dict(model, to_torch(feats))
        for mod in model.cfg.MODALITIES:
            np.testing.assert_allclose(wsi[mod].detach().numpy(),
                                       gold[f"{prefix}/wsi/{mod}"], **TOL, err_msg=mod)
            np.testing.assert_allclose(toks[mod].detach().numpy(),
                                       gold[f"{prefix}/tok/{mod}"], **TOL, err_msg=mod)


def _jax_cfg(cfg):
    from madeleine_tpu.config import MadeleineConfig as JaxConfig

    fields = {k: getattr(cfg, k) for k in (
        "patch_embedding_dim", "wsi_encoder_hidden_dim", "attention_hidden_dim", "n_heads",
        "precision", "dataset", "MODALITIES", "temperature", "lr", "end_learning_rate",
        "max_epochs", "warmup", "warmup_epochs", "weight_decay", "symmetric_cl", "local_loss",
        "global_loss", "modality_scan")}
    return JaxConfig(**fields).finalize()


def test_unported_options_raise_and_name_the_roadmap_item():
    x = torch.zeros(2, 3, 8, 64)
    _, _, _, model = param_pair()
    with pytest.raises(NotImplementedError, match="ROADMAP.md D3b"):
        port.forward_train(model, x, n_views=3)
    _, cfg, _, _ = param_pair(local_loss="got")
    with pytest.raises(NotImplementedError, match="ROADMAP.md A6"):
        compute_losses(cfg, torch.zeros(2, 3, 1, 4), torch.zeros(2, 3, 8, 4), torch.ones(2, 3),
                       None, token_mask=torch.ones(2, 3, 8, dtype=torch.bool))


STEP_CFG = dict(local_loss="-1", temperature=0.001, lr=1e-4, warmup=False, max_epochs=3,
                weight_decay=0.01, symmetric_cl=True)


def _jax_run(jcfg, params, batch, steps):
    """JAX's jitted step (fused encoder op, interpret mode) for `steps`
    steps; also the gradient of the first step's loss."""
    tx, _ = jax_optim.make_optimizer(jcfg, steps_per_epoch=10)
    state = jax_trainer.init_train_state(jax.tree_util.tree_map(jnp.asarray, params), tx)
    step = jax_trainer.make_train_step(jcfg, tx, donate=False)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        slide, tok = mtm.forward_train(p, jcfg, jb["feats"], n_views=1,
                                       rng=jax.random.PRNGKey(0), train=True)
        return jax_trainer.compute_losses(jcfg, slide.astype(jnp.float32), tok,
                                          jb["modality_labels"], jb["sample_mask"],
                                          jax.random.PRNGKey(1))[0]

    grads = jax.grad(loss_fn)(state.params)
    losses, trees = [], []
    for i in range(steps):
        state, _, metrics = step(state, jb, jax.random.PRNGKey(i))
        losses.append(float(metrics["loss"]))
        trees.append(params_from_jax(jax.tree_util.tree_map(np.asarray, state.params)))
    return losses, grads, trees


@pytest.mark.parametrize("scan", [True, False], ids=["scan", "joint"])
def test_train_steps_match_jax(monkeypatch, rates_zero, scan):
    """Two f32 steps at rates 0. Loss: rtol 1e-4 (temperature 0.001 multiplies
    the logits' f32 rounding by 1000). Gradients of step 1: relative
    Frobenius error 1e-4 per tensor. Parameters after each step: within 1% of
    the learning rate. Two exceptions, the same on both sides: the token
    projector's gradient is exactly 0 (InfoNCE does not read the tokens), and
    each attention_c bias has an exact gradient of 0 (a softmax is shift
    invariant), so both sides hold rounding noise there (atol 1e-4) and Adam,
    which divides a gradient by its own size, moves that bias by up to lr
    either way."""
    monkeypatch.setenv("MADELEINE_FORCE_FUSED", "1")
    jcfg, pcfg, params, model = param_pair(modality_scan=scan, **STEP_CFG)
    batch = train_batch(np.random.default_rng(3), bs=6, n_mod=3, t=16, d=64)
    want_losses, jgrads, want_params = _jax_run(jcfg, params, batch, 2)
    want_grads = grads_as_state_dict(jgrads, params)
    model.train()
    opt, sched = make_optimizer(pcfg, model.parameters(), steps_per_epoch=10)
    step = make_train_step(pcfg, model, opt, sched)
    lr = pcfg.lr
    noise_only = lambda k: k.endswith("attention_c.bias")
    for i in range(2):
        _, metrics = step(batch, seed=i)
        assert not metrics["skipped"]
        np.testing.assert_allclose(float(metrics["loss"]), want_losses[i], rtol=1e-4)
        if i == 0:
            for k, p in model.named_parameters():
                ref = want_grads[k]
                if k.startswith("token_projector"):
                    assert not p.grad.any() and not ref.any(), k
                elif noise_only(k):
                    assert float((p.grad - ref).abs().max()) <= 1e-4, k
                else:
                    err = float((p.grad - ref).norm() / ref.norm())
                    assert err < 1e-4, (k, err)
        for k, p in model.state_dict().items():
            diff = float((p - want_params[i][k]).abs().max())
            assert diff <= (2.05 if noise_only(k) else 0.01) * lr * (i + 1), (i, k, diff)
    assert step.updates == 2


def test_got_train_steps_match_jax(monkeypatch, rates_zero):
    """Two f32 steps of InfoNCE + GOT (local_loss="got", weight 1) at rates
    0 against JAX's step on its unfused glue route (MADELEINE_NO_GOT_GLUE=1,
    the route the port takes). got_subsample = t = 16: GOT is invariant to
    the common permutation of the tokens that each side draws, so the two
    agree up to f32 rounding without sharing an RNG. Bars as
    test_train_steps_match_jax (the token projector, which GOT reads, is
    compared like every other tensor), except the parameters after each
    step: within 5% of the learning rate. Adam's first steps move each
    element by about lr times the sign of its gradient, and GOT leaves some
    attention_a elements with gradients at the f32 rounding floor, which
    then move by up to 1.7% of lr apart (gradients agree to 1.5e-5)."""
    monkeypatch.setenv("MADELEINE_FORCE_FUSED", "1")
    monkeypatch.setenv("MADELEINE_NO_GOT_GLUE", "1")
    jcfg, pcfg, params, model = param_pair(**dict(STEP_CFG, local_loss="got", got_subsample=16))
    batch = train_batch(np.random.default_rng(5), bs=6, n_mod=3, t=16, d=64)
    want_losses, jgrads, want_params = _jax_run(jcfg, params, batch, 2)
    want_grads = grads_as_state_dict(jgrads, params)
    model.train()
    opt, sched = make_optimizer(pcfg, model.parameters(), steps_per_epoch=10)
    step = make_train_step(pcfg, model, opt, sched)
    lr = pcfg.lr
    noise_only = lambda k: k.endswith("attention_c.bias")
    for i in range(2):
        _, metrics = step(batch, seed=i)
        assert not metrics["skipped"]
        np.testing.assert_allclose(float(metrics["loss"]), want_losses[i], rtol=1e-4)
        if i == 0:
            assert model.token_projector.weight.grad.abs().max() > 0
            for k, p in model.named_parameters():
                ref = want_grads[k]
                if noise_only(k):
                    assert float((p.grad - ref).abs().max()) <= 1e-4, k
                else:
                    err = float((p.grad - ref).norm() / ref.norm())
                    assert err < 1e-4, (k, err)
        for k, p in model.state_dict().items():
            diff = float((p - want_params[i][k]).abs().max())
            assert diff <= (2.05 if noise_only(k) else 0.05) * lr * (i + 1), (i, k, diff)
    assert step.updates == 2


def _port_step(**cfg):
    _, pcfg, _, model = param_pair(**dict(STEP_CFG, **cfg))
    opt, sched = make_optimizer(pcfg, model.parameters(), steps_per_epoch=10)
    return model, make_train_step(pcfg, model, opt, sched)


@pytest.mark.parametrize("case", ["he_only", "non_finite"])
def test_skipped_step_changes_nothing(case):
    """An H&E-only batch, or one whose loss is not finite, leaves the
    parameters, the optimizer state and the schedule's step as they were."""
    model, step = _port_step()
    batch = train_batch(np.random.default_rng(0), bs=4, n_mod=3, t=8, d=64,
                        he_only=case == "he_only")
    if case == "non_finite":
        batch["feats"][0, 0, 0, 0] = np.nan
    before = {k: v.clone() for k, v in model.state_dict().items()}
    _, metrics = step(batch, seed=0)
    assert metrics["skipped"] and step.updates == 0 and not step.optimizer.state
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())
    if case == "he_only":
        assert float(metrics["loss"]) == 0.0


def test_train_loop_loss_falls_on_a_correlated_set():
    """Stain bags share a per-case signal with their H&E bag: a few epochs of
    train_loop (with dropout on) lower the epoch loss; the rank is finite."""
    _, step = _port_step(temperature=0.1, lr=1e-3, max_epochs=4)
    rng = np.random.default_rng(0)
    batches = [train_batch(rng, bs=8, n_mod=3, t=8, d=64, signal=2.0) for _ in range(3)]
    for b in batches:
        b["modality_labels"][:] = 1.0
    losses = []
    for epoch in range(4):
        loss, rank, agg = train_loop(step.cfg, step, batches, epoch, seed=0)
        losses.append(loss)
        assert agg["n_steps"] == 3 and np.isfinite(rank)
    assert losses[-1] < losses[0], losses
