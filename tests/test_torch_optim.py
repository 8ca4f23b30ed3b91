"""The train step's device-side skip (madeleine_torch/train/optim.py
`GatedAdamW`, `LrSchedule.on_device`) and the epoch loop's dispatch window
(train/trainer.py::train_loop), on the CPU: an applied update equals
torch.optim.AdamW bit for bit, a skipped one leaves every tensor as it was,
the device schedule equals the host one, the state dict crosses over to and
from torch.optim.AdamW, and every window gives the same epoch; the pretrain
CLI with the intra-modality loss resumes bit for bit."""

import copy
import json
import os

import numpy as np
import pytest
import torch

from madeleine_torch.cli import pretrain
from madeleine_torch.train import checkpoint as ckpt
from madeleine_torch.train.optim import make_lr_schedule, make_optimizer
from madeleine_torch.train.trainer import make_train_step, train_loop
from tests.test_torch_pretrain import _argv, _write_cohort
from tests.test_torch_train import STEP_CFG
from tests.torch_port_helpers import configs, param_pair, train_batch


def _params(seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.nn.Parameter(torch.randn(5, 7, generator=g)),
            torch.nn.Parameter(torch.randn(3, generator=g))]


@pytest.mark.parametrize("warmup", [True, False], ids=["warmup", "cosine"])
def test_applied_steps_equal_torch_adamw_bit_for_bit(warmup):
    """Twelve applied steps (warmup ramp, flat epoch, cosine) against
    torch.optim.AdamW (its single-tensor path) given the schedule's float
    learning rate before each step: parameters and both moments equal bit
    for bit, the returned learning rate equals the host schedule's."""
    _, cfg = configs(lr=1e-3, end_learning_rate=1e-6, weight_decay=0.01, warmup=warmup,
                     warmup_epochs=1, max_epochs=4)
    ps, qs = _params(), _params()
    opt, sched = make_optimizer(cfg, ps, steps_per_epoch=3)
    ref = torch.optim.AdamW(qs, lr=sched(0), betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01,
                            foreach=False)
    g = torch.Generator().manual_seed(1)
    for i in range(12):
        for p, q in zip(ps, qs):
            p.grad = torch.randn(p.shape, generator=g)
            q.grad = p.grad.clone()
        lr = opt.step(ok=torch.tensor(True))
        for group in ref.param_groups:
            group["lr"] = sched(i)
        ref.step()
        assert float(lr) == sched(i), i
        for p, q in zip(ps, qs):
            assert torch.equal(p, q), i
            for key in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(opt.state[p][key], ref.state[q][key]), (i, key)
    assert int(opt.count) == 12


@pytest.mark.parametrize("warmup", [True, False], ids=["warmup", "cosine"])
def test_device_schedule_equals_the_host_schedule(warmup):
    """LrSchedule.on_device at every count of a short run (through the
    warmup, the flat epoch, the cosine and past its end) equals the float the
    host schedule gives, exactly."""
    _, cfg = configs(lr=1e-4, end_learning_rate=1e-8, warmup=warmup, warmup_epochs=2,
                     max_epochs=5)
    sched = make_lr_schedule(cfg, steps_per_epoch=4)
    counts = torch.arange(0, 26)
    got = sched.on_device(counts)
    assert got.dtype == torch.float64
    assert [float(v) for v in got] == [sched(int(c)) for c in counts]


@pytest.mark.parametrize("case", ["he_only", "non_finite"])
def test_a_skipped_step_after_an_update_changes_nothing(case):
    """After one applied step (moments non-zero, count 1), an H&E-only batch
    or a non-finite loss leaves the parameters, both moments and the count
    bit for bit; the step still runs the backward (the gradients exist)."""
    _, pcfg, _, model = param_pair(**STEP_CFG)
    opt, sched = make_optimizer(pcfg, model.parameters(), steps_per_epoch=10)
    step = make_train_step(pcfg, model, opt, sched)
    rng = np.random.default_rng(2)
    _, metrics = step(train_batch(rng, bs=4, n_mod=3, t=8, d=64), seed=0)
    assert not metrics["skipped"] and int(step.updates) == 1
    batch = train_batch(rng, bs=4, n_mod=3, t=8, d=64, he_only=case == "he_only")
    if case == "non_finite":
        batch["feats"][0, 0, 0, 0] = np.nan
    before = {k: v.clone() for k, v in model.state_dict().items()}
    moments = {n: {k: opt.state[p][k].clone() for k in ("exp_avg", "exp_avg_sq")}
               for n, p in model.named_parameters()}
    _, metrics = step(batch, seed=1)
    assert bool(metrics["skipped"]) and int(step.updates) == 1
    assert all(p.grad is not None for p in model.parameters())
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())
    for n, p in model.named_parameters():
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(opt.state[p][k], moments[n][k]), (n, k)
    if case == "non_finite":
        assert not torch.isfinite(metrics["loss"])
    else:
        assert float(metrics["loss"]) == 0.0


def test_state_dict_crosses_over_with_torch_adamw():
    """A torch.optim.AdamW state dict (the checkpoints of earlier trees)
    loads: the moments and the count (from each parameter's step) as they
    were, and the next step equals AdamW's; the gated optimizer's state dict
    loads into torch.optim.AdamW with every parameter's step the count."""
    _, cfg = configs(lr=1e-3, weight_decay=0.01, warmup=False, max_epochs=4)
    ps, qs = _params(), _params()
    opt, sched = make_optimizer(cfg, ps, steps_per_epoch=3)
    ref = torch.optim.AdamW(qs, lr=sched(0), betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01,
                            foreach=False)
    g = torch.Generator().manual_seed(3)
    for i in range(3):
        for q in qs:
            q.grad = torch.randn(q.shape, generator=g)
        for group in ref.param_groups:
            group["lr"] = sched(i)
        ref.step()
    with torch.no_grad():
        for p, q in zip(ps, qs):
            p.copy_(q)
    opt.load_state_dict(copy.deepcopy(ref.state_dict()))   # as a checkpoint holds it
    assert int(opt.count) == 3
    for p, q in zip(ps, qs):
        p.grad = torch.randn(p.shape, generator=g)
        q.grad = p.grad.clone()
    opt.step()
    for group in ref.param_groups:
        group["lr"] = sched(3)
    ref.step()
    assert all(torch.equal(p, q) for p, q in zip(ps, qs))
    sd = opt.state_dict()
    assert [float(s["step"]) for s in sd["state"].values()] == [4.0, 4.0]
    back = torch.optim.AdamW(_params(), lr=1.0, weight_decay=0.01)
    back.load_state_dict(sd)
    for i, p in enumerate(back.param_groups[0]["params"]):
        assert torch.equal(back.state[p]["exp_avg"], opt.state[ps[i]]["exp_avg"])
        assert float(back.state[p]["step"]) == 4.0


def test_train_loop_windows_give_the_same_epoch(monkeypatch):
    """train_loop at dispatch windows 0, 1 and 8 (and 8 with log_every) over
    five batches, one of them H&E-only (skipped): the same epoch loss, rank,
    skip counts and per-step losses and skip flags, and the same parameters
    after the epoch, bit for bit."""
    rng = np.random.default_rng(4)
    batches = [train_batch(rng, bs=4, n_mod=3, t=8, d=64, he_only=i == 2) for i in range(5)]
    results = []
    for window, log_every in ((0, 0), (1, 0), (8, 0), (8, 2)):
        monkeypatch.setenv("MADELEINE_DISPATCH_WINDOW", str(window))
        _, pcfg, _, model = param_pair(**STEP_CFG)
        opt, sched = make_optimizer(pcfg, model.parameters(), steps_per_epoch=5)
        step = make_train_step(pcfg, model, opt, sched)
        loss, rank, agg = train_loop(pcfg, step, batches, epoch=0, seed=0, log_every=log_every)
        results.append((loss, rank, agg["n_steps"], agg["n_skipped"],
                        [(s["loss"], s["skipped"]) for s in agg["steps"]],
                        {k: v.clone() for k, v in model.state_dict().items()}))
        assert int(step.updates) == 4
    first = results[0]
    assert first[2:4] == (4, 1) and first[4][2][1] and np.isfinite(first[1])
    for other in results[1:]:
        assert other[:5] == first[:5]
        assert all(torch.equal(other[5][k], v) for k, v in first[5].items())


def test_window_comes_from_the_environment(monkeypatch):
    from madeleine_torch.train.trainer import dispatch_window

    assert dispatch_window() == 8
    monkeypatch.setenv("MADELEINE_DISPATCH_WINDOW", "0")
    assert dispatch_window() == 0


def test_pretrain_cli_with_the_intra_loss_resumes_bit_for_bit(tmp_path):
    """--intra_modality_loss info-nce (n_views=3) through the CLI: one epoch
    resumed to two equals two straight, model.pt and the AdamW state bit for
    bit (the half-bag split is keyed by the step's seed), every step finite
    and applied."""
    root = str(tmp_path)
    _write_cohort(root, 11, 16, lengths=(20, 60))
    intra = ("--intra_modality_loss", "info-nce")
    run_a = pretrain.main(_argv(root, os.path.join(root, "a"), 1, *intra))
    run_b = pretrain.main(_argv(root, os.path.join(root, "b"), 2, "--resume",
                                os.path.join(run_a, "train_state"), *intra))
    run_c = pretrain.main(_argv(root, os.path.join(root, "c"), 2, *intra))
    sb = torch.load(os.path.join(run_b, "model.pt"))
    sc = torch.load(os.path.join(run_c, "model.pt"))
    assert sb.keys() == sc.keys() and all(torch.equal(sb[k], sc[k]) for k in sb)
    tb = ckpt.restore_train_state(os.path.join(run_b, "train_state"))
    tc = ckpt.restore_train_state(os.path.join(run_c, "train_state"))
    assert tb["updates"] == tc["updates"] == 4
    ob, oc = tb["optimizer"]["state"], tc["optimizer"]["state"]
    for i in ob:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(ob[i][k], oc[i][k]), (i, k)
    records = [json.loads(line) for line in open(os.path.join(run_c, "metrics.jsonl"))]
    steps = [s for r in records if "steps" in r for s in r["steps"]]
    assert len(steps) == 4 and all(np.isfinite(s["loss"]) and not s["skipped"] for s in steps)
