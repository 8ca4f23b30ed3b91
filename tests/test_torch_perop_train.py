"""The port's per-op training lane, the route of a non-softmax attention
activation (JAX madeleine.py:157-172,226-248; abmil.py:134-214,255-345):
`forward_train` and the InfoNCE + GOT train step against the JAX package's
per-op route on the CPU at dropout rates 0 (its rates monkeypatched, the
package not edited), f32; and the pretrain CLI with --activation sigmoid,
resumed bit for bit."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madeleine_tpu.models import abmil as jax_abmil
from madeleine_tpu.models import madeleine as mtm
from madeleine_torch.cli import pretrain
from madeleine_torch.models import madeleine as port
from madeleine_torch.ops import gated_logits as gl
from madeleine_torch.ops import preattn as pa
from madeleine_torch.train.optim import make_optimizer
from madeleine_torch.train.trainer import make_train_step
from tests.test_torch_pretrain import _argv, _write_cohort
from tests.test_torch_train import STEP_CFG, _jax_run
from tests.torch_port_helpers import (grads_as_state_dict, param_pair, ragged_mask, to_torch,
                                      train_batch)

TOL = dict(rtol=1e-4, atol=1e-5)   # tests/test_golden.py's bar


@pytest.fixture
def rates_zero(monkeypatch):
    """Both packages' per-op dropout rates set to 0 (each reads them at call
    or trace time)."""
    monkeypatch.setattr(jax_abmil, "PRE_ATTN_DROPOUT", 0.0)
    monkeypatch.setattr(jax_abmil, "ATTN_DROPOUT", 0.0)
    monkeypatch.setattr(pa, "RATE", 0.0)
    monkeypatch.setattr(gl, "RATE", 0.0)


def _no_fused_encoder(*_, **__):
    raise AssertionError("a non-softmax activation must not take the whole-encoder op")


@pytest.mark.parametrize("se", [False, True], ids=["plain", "stain_codes"])
@pytest.mark.parametrize("scan", [True, False], ids=["scan", "joint"])
@pytest.mark.parametrize("activation", ["sigmoid", "relu", "leaky_relu"])
def test_forward_train_matches_jax(monkeypatch, rates_zero, activation, scan, se):
    """slide and token embeddings of the train forward at rates 0, ragged
    bags (one stain of one case empty), against JAX's per-op forward_train
    (train=True) and against the port's own eval forward, at rtol 1e-4 /
    atol 1e-5; the whole-encoder op is never called."""
    monkeypatch.setattr(port, "encoder_train", _no_fused_encoder)
    jcfg, _, params, model = param_pair(seed=6, activation=activation, modality_scan=scan,
                                        add_stain_encoding=se)
    feats = train_batch(np.random.default_rng(7), bs=4, n_mod=3, t=16, d=64)["feats"]
    mask = np.stack([ragged_mask([16, 9, 3, 12], 16), ragged_mask([5, 16, 0, 8], 16),
                     ragged_mask([16, 16, 7, 1], 16)], axis=1)
    js, jt = mtm.forward_train(jax.tree_util.tree_map(jnp.asarray, params), jcfg,
                               jnp.asarray(feats), mask=jnp.asarray(mask), n_views=1,
                               rng=jax.random.PRNGKey(0), train=True)
    with torch.no_grad():
        slide, tok = port.forward_train(model, to_torch(feats), mask=torch.from_numpy(mask),
                                        seed=3)
    np.testing.assert_allclose(slide.numpy(), np.asarray(js), **TOL)
    np.testing.assert_allclose(tok.numpy(), np.asarray(jt), **TOL)
    es, etok = port.forward_train(model, to_torch(feats), mask=torch.from_numpy(mask),
                                  train=False)
    np.testing.assert_allclose(slide.numpy(), es.numpy(), **TOL)
    np.testing.assert_allclose(tok.numpy(), etok.numpy(), **TOL)


def test_forward_train_masks_follow_the_global_rows():
    """At the reference rates the scan route's modality m, case i draws its
    masks at global row m*bs + i: a joint-route call whose rows are ordered
    modality-major, with the same seed, gives the scan route's embeddings
    bit for bit; the joint route's own order (i*n_mod + m) gives others."""
    _, cfg, _, model = param_pair(seed=8, activation="sigmoid")
    feats = to_torch(train_batch(np.random.default_rng(9), bs=3, n_mod=3, t=8, d=64)["feats"])
    with torch.no_grad():
        cfg.modality_scan = True
        scan_s, scan_t = port.forward_train(model, feats, seed=5)
        cfg.modality_scan = False
        mod_major = feats.transpose(0, 1).reshape(1, 9, 8, 64)
        joint_s, joint_t = port.forward_train(model, mod_major, seed=5)
        own_s, _ = port.forward_train(model, feats, seed=5)
    assert torch.equal(joint_s.reshape(3, 3, 1, -1).transpose(0, 1), scan_s)
    assert torch.equal(joint_t.reshape(3, 3, 8, -1).transpose(0, 1), scan_t)
    assert not torch.equal(own_s, scan_s)


def test_got_train_steps_with_sigmoid_match_jax(monkeypatch, rates_zero):
    """Three f32 steps of InfoNCE + GOT (weight 1, got_subsample = t = 16)
    with the sigmoid activation at rates 0 against JAX's step on its per-op
    route (the GOT glue on its unfused route, MADELEINE_NO_GOT_GLUE=1, which
    the port's fused glue equals: tests/test_torch_got_glue.py). Bars as
    tests/test_torch_train.py::test_got_train_steps_match_jax: the loss at
    rtol 1e-4, step 1's gradients at 1e-4 relative Frobenius per tensor,
    the parameters after each step within 5% of the learning rate. As
    there, the attention_c biases are held to atol 1e-4 and 2.05 lr per
    step: each one's gradient is the sum of the logits' cotangent over all
    tokens, whose terms largely cancel (its norm 0.15-0.46 against 5-7 for
    attention_c's weight; both sides' absolute errors about 5e-5), and Adam
    divides a gradient by its own size. So is any element whose step-1
    gradient lies at the f32 rounding floor of its tensor (below 1e-5 of
    its largest)."""
    monkeypatch.setenv("MADELEINE_NO_GOT_GLUE", "1")
    jcfg, pcfg, params, model = param_pair(
        activation="sigmoid", **dict(STEP_CFG, local_loss="got", got_subsample=16))
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
    assert step.updates == 3


def test_pretrain_cli_with_sigmoid_resumes_bit_for_bit(tmp_path):
    """`python -m madeleine_torch.cli.pretrain --activation sigmoid --device
    cpu` (in-process, InfoNCE + GOT, dropout on): A 1 epoch, B A resumed to 2
    epochs, C 2 epochs straight; every loss finite, none skipped, the config
    records the activation, and B's model.pt equals C's bit for bit."""
    root = str(tmp_path)
    _write_cohort(root, 11, 16, lengths=(20, 60))
    run_a = pretrain.main(_argv(root, os.path.join(root, "a"), 1, "--activation", "sigmoid"))
    run_b = pretrain.main(_argv(root, os.path.join(root, "b"), 2, "--activation", "sigmoid",
                                "--resume", os.path.join(run_a, "train_state")))
    run_c = pretrain.main(_argv(root, os.path.join(root, "c"), 2, "--activation", "sigmoid"))
    for run in (run_a, run_b, run_c):
        assert json.load(open(os.path.join(run, "config.json")))["activation"] == "sigmoid"
        records = [json.loads(line) for line in open(os.path.join(run, "metrics.jsonl"))]
        steps = [s for r in records if "steps" in r for s in r["steps"]]
        assert steps and all(np.isfinite(s["loss"]) and not s["skipped"] for s in steps)
    sb = torch.load(os.path.join(run_b, "model.pt"))
    sc = torch.load(os.path.join(run_c, "model.pt"))
    assert sb.keys() == sc.keys() and all(torch.equal(sb[k], sc[k]) for k in sb)
    sa = torch.load(os.path.join(run_a, "model.pt"))
    assert not all(torch.equal(sa[k], sc[k]) for k in sa)
