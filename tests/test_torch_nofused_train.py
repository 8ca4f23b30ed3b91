"""The softmax per-op lane, the route of a softmax train step with
MADELEINE_NO_FUSED_ENCODER set (JAX madeleine.py:157-174; abmil.py:134-214,
255-345): `forward_train` and the InfoNCE + GOT train step against the JAX
package under the same variable, on the CPU at dropout rates 0 (both
packages' rates monkeypatched, neither package edited), f32; the step with
the variable unset still taking the whole-encoder op; and the pretrain CLI
under the variable, resumed bit for bit. On the CPU the lane runs the plain
versions of kernels 15-20 and of the training pool's rows 4-5."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madeleine_tpu.models import madeleine as mtm
from madeleine_torch.cli import pretrain
from madeleine_torch.models import abmil as port_abmil
from madeleine_torch.models import madeleine as port
from madeleine_torch.ops import attn_pool as ap
from madeleine_torch.train.optim import make_optimizer
from madeleine_torch.train.trainer import make_train_step
from tests.test_torch_perop_train import rates_zero  # noqa: F401 (a fixture)
from tests.test_torch_pretrain import _argv, _write_cohort
from tests.test_torch_train import STEP_CFG, _jax_run
from tests.torch_port_helpers import (grads_as_state_dict, param_pair, ragged_mask, to_torch,
                                      train_batch)

TOL = dict(rtol=1e-4, atol=1e-5)   # tests/test_golden.py's bar
VAR = "MADELEINE_NO_FUSED_ENCODER"


@pytest.fixture
def no_fused(monkeypatch):
    """The variable set for both packages (each reads it at call or trace
    time; monkeypatch restores it), and a spy on the port's training pool:
    returns the list of its calls."""
    monkeypatch.setenv(VAR, "1")
    calls = []
    pool = port_abmil.fused_attention_pool

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return pool(*args, **kw)

    monkeypatch.setattr(port_abmil, "fused_attention_pool", spy)
    monkeypatch.setattr(port, "encoder_train", _no_fused_encoder)
    return calls


def _no_fused_encoder(*_, **__):
    raise AssertionError(f"with {VAR} set, softmax must not take the whole-encoder op")


@pytest.mark.parametrize("se", [False, True], ids=["plain", "stain_codes"])
@pytest.mark.parametrize("scan", [True, False], ids=["scan", "joint"])
def test_forward_train_matches_jax(rates_zero, no_fused, scan, se):
    """slide and token embeddings of the softmax train forward at rates 0,
    ragged bags (one stain of one case empty), against JAX's forward_train
    (train=True) under the variable and against the port's own eval
    forward, at rtol 1e-4 / atol 1e-5; the pool is the training pool, once
    per modality on the scan route and once on the joint route."""
    jcfg, _, params, model = param_pair(seed=6, modality_scan=scan, add_stain_encoding=se)
    feats = train_batch(np.random.default_rng(7), bs=4, n_mod=3, t=16, d=64)["feats"]
    mask = np.stack([ragged_mask([16, 9, 3, 12], 16), ragged_mask([5, 16, 0, 8], 16),
                     ragged_mask([16, 16, 7, 1], 16)], axis=1)
    js, jt = mtm.forward_train(jax.tree_util.tree_map(jnp.asarray, params), jcfg,
                               jnp.asarray(feats), mask=jnp.asarray(mask), n_views=1,
                               rng=jax.random.PRNGKey(0), train=True)
    with torch.no_grad():
        slide, tok = port.forward_train(model, to_torch(feats), mask=torch.from_numpy(mask),
                                        seed=3)
    assert len(no_fused) == (3 if scan else 1)
    np.testing.assert_allclose(slide.numpy(), np.asarray(js), **TOL)
    np.testing.assert_allclose(tok.numpy(), np.asarray(jt), **TOL)
    es, etok = port.forward_train(model, to_torch(feats), mask=torch.from_numpy(mask),
                                  train=False)
    np.testing.assert_allclose(slide.numpy(), es.numpy(), **TOL)
    np.testing.assert_allclose(tok.numpy(), etok.numpy(), **TOL)


def test_got_train_steps_match_jax(monkeypatch, rates_zero, no_fused):
    """Three f32 steps of InfoNCE + GOT (weight 1, got_subsample = t = 16)
    with softmax under the variable at rates 0 against JAX's step under it
    (the GOT glue on its unfused route, MADELEINE_NO_GOT_GLUE=1, which the
    port's fused glue equals: tests/test_torch_got_glue.py). Bars as
    tests/test_torch_perop_train.py::test_got_train_steps_with_sigmoid_match_jax:
    the loss at rtol 1e-4, step 1's gradients at 1e-4 relative Frobenius per
    tensor, the parameters after each step within 5% of the learning rate;
    the attention_c biases at atol 1e-4 and 2.05 lr per step (with softmax
    their exact gradient is 0, so each side's is rounding), as is any
    element whose step-1 gradient lies at the f32 rounding floor of its
    tensor (below 1e-5 of its largest)."""
    monkeypatch.setenv("MADELEINE_NO_GOT_GLUE", "1")
    jcfg, pcfg, params, model = param_pair(**dict(STEP_CFG, local_loss="got", got_subsample=16))
    batch = train_batch(np.random.default_rng(10), bs=6, n_mod=3, t=16, d=64)
    want_losses, jgrads, want_params = _jax_run(jcfg, params, batch, 3)
    want_grads = grads_as_state_dict(jgrads, params)
    model.train()
    opt, sched = make_optimizer(pcfg, model.parameters(), steps_per_epoch=10)
    step = make_train_step(pcfg, model, opt, sched)
    lr = pcfg.lr
    noise_only = lambda k: k.endswith("attention_c.bias")
    at_floor = {k: (g.abs() <= 1e-5 * g.abs().max()) | noise_only(k)
                for k, g in want_grads.items()}
    for i in range(3):
        _, metrics = step(batch, seed=i)
        assert not metrics["skipped"]
        np.testing.assert_allclose(float(metrics["loss"]), want_losses[i], rtol=1e-4)
        if i == 0:
            for k, p in model.named_parameters():
                ref = want_grads[k]
                if noise_only(k):
                    assert float((p.grad - ref).abs().max()) <= 1e-4, k
                else:
                    err = float((p.grad - ref).norm() / ref.norm())
                    assert err < 1e-4, (k, err)
        for k, p in model.state_dict().items():
            diff = (p - want_params[i][k]).abs()
            bar = torch.where(at_floor[k], 2.05, 0.05) * lr * (i + 1)
            assert (diff <= bar).all(), (i, k, float(diff.max()))
    # 3 steps of 3 modalities, each pool run again by cfg.remat's recompute in its backward
    assert step.updates == 3 and len(no_fused) == 3 * 3 * 2


def test_unset_variable_keeps_the_whole_encoder_op(monkeypatch):
    """With the variable unset (or empty) a softmax step calls
    encoder_train once per modality and never the training pool; with it
    set to any non-empty value, even "0", the reverse (JAX's semantics)."""
    calls = {"encoder_train": 0, "pool": 0}
    enc, pool = port.encoder_train, port_abmil.fused_attention_pool

    def enc_spy(*a, **k):
        calls["encoder_train"] += 1
        return enc(*a, **k)

    def pool_spy(*a, **k):
        calls["pool"] += 1
        return pool(*a, **k)

    monkeypatch.setattr(port, "encoder_train", enc_spy)
    monkeypatch.setattr(port_abmil, "fused_attention_pool", pool_spy)
    _, _, _, model = param_pair(seed=2)
    feats = to_torch(train_batch(np.random.default_rng(3), bs=2, n_mod=3, t=8, d=64)["feats"])
    for value, want in ((None, (3, 0)), ("", (3, 0)), ("0", (0, 3)), ("1", (0, 3))):
        if value is None:
            monkeypatch.delenv(VAR, raising=False)
        else:
            monkeypatch.setenv(VAR, value)
        calls.update(encoder_train=0, pool=0)
        with torch.no_grad():
            port.forward_train(model, feats, seed=1)
        assert (calls["encoder_train"], calls["pool"]) == want, value


def test_pretrain_cli_under_the_variable_resumes_bit_for_bit(tmp_path, monkeypatch):
    """`python -m madeleine_torch.cli.pretrain --device cpu` (in-process,
    softmax, InfoNCE + GOT, dropout on) with the variable set: A 1 epoch, B
    A resumed to 2 epochs, C 2 epochs straight; the training pool runs on
    every step, every loss is finite, none skipped, and B's model.pt equals
    C's bit for bit."""
    monkeypatch.setenv(VAR, "1")
    calls, plain = [], ap.pool_ms_plain
    monkeypatch.setattr(ap, "pool_ms_plain", lambda *a: calls.append(1) or plain(*a))
    monkeypatch.setattr(port, "encoder_train", _no_fused_encoder)
    root = str(tmp_path)
    _write_cohort(root, 11, 16, lengths=(20, 60))
    run_a = pretrain.main(_argv(root, os.path.join(root, "a"), 1))
    run_b = pretrain.main(_argv(root, os.path.join(root, "b"), 2,
                                "--resume", os.path.join(run_a, "train_state")))
    run_c = pretrain.main(_argv(root, os.path.join(root, "c"), 2))
    n_steps = 0
    for run in (run_a, run_b, run_c):
        records = [json.loads(line) for line in open(os.path.join(run, "metrics.jsonl"))]
        steps = [s for r in records if "steps" in r for s in r["steps"]]
        assert steps and all(np.isfinite(s["loss"]) and not s["skipped"] for s in steps)
        n_steps += len(steps)
    assert len(calls) >= n_steps * 5   # every step pools each of the 5 stains
    sb = torch.load(os.path.join(run_b, "model.pt"))
    sc = torch.load(os.path.join(run_c, "model.pt"))
    assert sb.keys() == sc.keys() and all(torch.equal(sb[k], sc[k]) for k in sb)

