"""Full-bag (ragged) training in the port, on the CPU, against the JAX
package: the Python ragged loader (`RaggedTrainLoader`) bit for bit, the
masked GOT subsample (`masked_subsample` on JAX's Gumbel noise) bit for bit
and the port's own draw, the save_acts gate (`resolve_save_acts`), the
encoder op's recompute route (plain versions; JAX's op in interpret mode,
rates 0), a ragged train step with an all-masked stain against JAX's, and
`train_loop` over the ragged loader with poisoned padding."""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madeleine_tpu.data import datasets as JD
from madeleine_tpu.models import madeleine as mtm
from madeleine_tpu.ops import encoder_train as jet
from madeleine_tpu.ops import losses as JL
from madeleine_tpu.train import optim as jax_optim
from madeleine_tpu.train import trainer as jax_trainer
from madeleine_torch.config import MODALITY_DICTS
from madeleine_torch.data import datasets as PD
from madeleine_torch.models.factory import params_from_jax
from madeleine_torch.models.madeleine import forward_train, train_weights
from madeleine_torch.ops import encoder_train as et
from madeleine_torch.ops import losses as L
from madeleine_torch.train.optim import make_optimizer
from madeleine_torch.train.trainer import got_gumbel, make_train_step, train_loop
from tests.torch_port_helpers import (grads_as_state_dict, param_pair, ragged_mask, to_torch,
                                      train_batch)

STAINS = MODALITY_DICTS["ACROBAT"]


# ---------------------------------------------------------------------------
# RaggedTrainLoader
# ---------------------------------------------------------------------------

def _write_cohort(root, lengths, d=8, seed=0):
    """<root>/feats/case{i}_{stain}.npz with the given [n_cases, n_stains]
    lengths (0: the stain is absent, its CSV label 0), <root>/ACROBAT.csv."""
    rng = np.random.default_rng(seed)
    feats = os.path.join(root, "feats")
    os.makedirs(feats)
    rows = []
    for i, case in enumerate(lengths):
        for s, n in zip(STAINS, case):
            if n:
                np.savez(os.path.join(feats, f"case{i}_{s}.npz"),
                         features=rng.standard_normal((int(n), d)).astype(np.float32))
        rows.append({"slide_id": f"case{i}", **{s: int(n > 0) for s, n in zip(STAINS, case)},
                     "split": "train"})
    csv_path = os.path.join(root, "ACROBAT.csv")
    with open(csv_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    return csv_path, feats


def _ragged_lengths(n_cases, seed=1):
    """Bag lengths 5-40, HE always present, other stains absent at random,
    one bag of 70 (past the top bucket 32: the buckets grow to 128)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(5, 41, (n_cases, len(STAINS)))
    lengths[:, 1:] *= rng.random((n_cases, len(STAINS) - 1)) < 0.7
    lengths[3, 2] = 70
    return lengths


@pytest.mark.parametrize("max_tokens", [None, 30], ids=["whole", "capped"])
def test_ragged_train_loader_equals_jax(tmp_path, max_tokens):
    """11 cases in batches of 4 (the last padded by repeating its first
    case, masked), buckets (16, 32): a bag of 70 tokens grows its batch's
    bucket to 128 (whole) or is capped at 30 (capped, every capped bag
    counted); missing stains (the 2-row zero placeholder, label 0): feats,
    token_mask, modality_labels, sample_mask and slide_ids equal the JAX
    package's RaggedTrainLoader bit for bit over two epochs, as does the
    truncation count."""
    lengths = _ragged_lengths(11)
    csv_path, feats = _write_cohort(str(tmp_path), lengths)
    kw = dict(embedding_size=8, sample=-1)
    lk = dict(buckets=(16, 32), seed=3, max_tokens=max_tokens)
    ours = PD.RaggedTrainLoader(PD.SlideDataset("ACROBAT", csv_path, feats, STAINS, **kw), 4, **lk)
    theirs = JD.RaggedTrainLoader(JD.SlideDataset("ACROBAT", csv_path, feats, STAINS, **kw), 4,
                                  **lk)
    assert len(ours) == len(theirs) == 3
    buckets = set()
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            for key in ("feats", "token_mask", "modality_labels", "sample_mask"):
                assert g[key].dtype == w[key].dtype and np.array_equal(g[key], w[key]), (epoch,
                                                                                        key)
            assert g["slide_ids"] == list(w["slide_ids"])
            assert not g["feats"][~g["token_mask"]].any()
            buckets.add(g["feats"].shape[2])
        assert got[-1]["sample_mask"].tolist() == [True, True, True, False]
        assert not got[-1]["modality_labels"][3].any() and len(got[-1]["slide_ids"]) == 3
        assert any((g["modality_labels"] == 0).any() for g in got)   # a missing stain
        # a missing stain is the 2-row placeholder: two valid zero tokens
        b, m = np.argwhere(got[0]["modality_labels"] == 0)[0]
        assert got[0]["token_mask"][b, m].sum() == 2 and not got[0]["feats"][b, m].any()
    assert ours.truncation_count == theirs.truncation_count
    assert (ours.truncation_count == 0) == (max_tokens is None)
    assert 128 in buckets if max_tokens is None else buckets == {32}


def test_ragged_train_loader_refuses_what_is_not_ported(tmp_path):
    """Several processes (A7) run: at process_count 2 the two ranks' batches
    agree on the bucket, the global batch's from the bags' headers (the bag
    of 70 grows it to 128 on both ranks, whichever holds it), and are the
    JAX package's local batches bit for bit; an odd split and a subsampling
    dataset raise."""
    csv_path, feats = _write_cohort(str(tmp_path), _ragged_lengths(4))
    ds = PD.SlideDataset("ACROBAT", csv_path, feats, STAINS, embedding_size=8, sample=-1)
    kw = dict(buckets=(16, 32), seed=3)
    per_rank = []
    for rank in (0, 1):
        ours = PD.RaggedTrainLoader(ds, 4, process_index=rank, process_count=2, **kw)
        theirs = JD.RaggedTrainLoader(JD.SlideDataset("ACROBAT", csv_path, feats, STAINS,
                                                      embedding_size=8, sample=-1), 4,
                                      process_index=rank, process_count=2, **kw)
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == 1
        for key in ("feats", "token_mask", "modality_labels", "sample_mask"):
            assert np.array_equal(got[0][key], want[0][key]), (rank, key)
        assert got[0]["slide_ids"] == list(want[0]["slide_ids"])
        per_rank.append(got[0])
    assert [b["feats"].shape for b in per_rank] == [(2, 5, 128, 8)] * 2
    assert (per_rank[0]["token_mask"].sum(-1).max() == 70) != \
        (per_rank[1]["token_mask"].sum(-1).max() == 70)
    with pytest.raises(ValueError, match="not divisible"):
        PD.RaggedTrainLoader(ds, 4, process_count=3)
    with pytest.raises(ValueError, match="sample=-1"):
        PD.RaggedTrainLoader(PD.SlideDataset("ACROBAT", csv_path, feats, STAINS,
                                           embedding_size=8, sample=16), 4)
    assert PD.grow_bucket(70, 32) == 128 and PD.bucket_of(17, (16, 32)) == 32


# ---------------------------------------------------------------------------
# the masked GOT subsample
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sub", [8, 12, 30], ids=["valid_ge_sub", "valid_eq_sub", "valid_lt_sub"])
def test_masked_subsample_on_jax_noise_equals_jax(sub):
    """Bags of 30, 12, 5 and 0 valid tokens of 30 (prefix and scattered
    masks): on JAX's Gumbel noise the port's draw equals JAX's bit for bit,
    for n_valid >= sub (no repeats), n_valid < sub (a permutation of the
    valid tokens, tiled) and an empty bag (token 0)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, 30, 6)).astype(np.float32)
    mask = ragged_mask([30, 12, 5, 0, 30], 30)
    mask[4] = rng.random(30) < 0.5                       # a scattered mask
    key = jax.random.PRNGKey(7)
    want = np.asarray(JL.masked_subsample(jnp.asarray(x), jnp.asarray(mask), key, sub))
    noise = torch.from_numpy(np.array(jax.random.gumbel(key, mask.shape)))
    got = L.masked_subsample(to_torch(x), torch.from_numpy(mask), sub, noise).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got[3], np.repeat(x[3, :1], sub, axis=0))   # empty: token 0
    if sub <= 12:
        assert len({r.tobytes() for r in got[1]}) == sub             # no repeats


def test_port_draw_has_no_repeats_and_does_not_change_with_the_bucket():
    """The port's own noise (got_gumbel): a bag with at least `sub` valid
    tokens gives `sub` distinct ones; padding the batch to a larger bucket
    gives the same noise on the first t tokens and the same subsample;
    another seed or stream draws otherwise; the noise is standard Gumbel."""
    t, sub = 40, 16
    rng = np.random.default_rng(5)
    x = to_torch(rng.standard_normal((4, t, 6)))
    mask = torch.from_numpy(ragged_mask([40, 16, 9, 0], t))
    noise = got_gumbel(3, 3, 4, t, "cpu")
    wide = got_gumbel(3, 3, 4, 4 * t, "cpu")
    assert noise.shape == (2, 2, 4, t) and torch.equal(wide[..., :t], noise)
    got = L.masked_subsample(x, mask, sub, noise[1, 0])
    padded = L.masked_subsample(torch.nn.functional.pad(x, (0, 0, 0, 3 * t)),
                                torch.nn.functional.pad(mask, (0, 3 * t)), sub, wide[1, 0])
    assert torch.equal(got, padded)
    for i in (0, 1):
        assert len({tuple(r.tolist()) for r in got[i]}) == sub
    assert not torch.equal(noise[0, 0], noise[0, 1])
    assert not torch.equal(noise, got_gumbel(4, 3, 4, t, "cpu"))
    big = got_gumbel(0, 2, 64, 4096, "cpu")
    assert abs(float(big.mean()) - 0.5772) < 0.01 and abs(float(big.var()) - 1.6449) < 0.03


# ---------------------------------------------------------------------------
# the save_acts gate
# ---------------------------------------------------------------------------

SHAPES = [(65, 2048, 512, 2048, 4096, 2), (65, 16384, 512, 2048, 4096, 2),
          (8, 96, 128, 256, 512, 4), (1, 1, 128, 128, 256, 2)]


def _saved_bytes(b, t, h, E, nhf2, itemsize):
    return b * t * ((2 * h + E + nhf2) * itemsize + 3 * 4)


@pytest.mark.parametrize("shape", SHAPES, ids=["step_2048", "bucket_16384", "small", "one_row"])
def test_resolve_save_acts_equals_jax(monkeypatch, shape):
    """Over budgets at, below and above the call's saves (and the 10 GiB
    default), device limits none, tight and loose around the guard's
    saves + 4 x_bytes + 2 GiB, explicit save_acts None / True / False and
    MADELEINE_ENCODER_NO_SAVE_ACTS unset and set: the port's route is JAX's
    `_resolve_save_acts`."""
    assert et._device_hbm_limit("cpu") is None
    saved = _saved_bytes(*shape)
    x_bytes = shape[0] * shape[1] * 512 * shape[5]
    guard = saved + 4 * x_bytes + 2 * 1024 ** 3
    seen = set()
    for budget in (saved - 1, saved, saved + 1, 10 * 1024 ** 3):
        monkeypatch.setattr(jet, "ACT_BUDGET_BYTES", budget)
        monkeypatch.setattr(et, "ACT_BUDGET_BYTES", budget)
        for limit in (None, guard - 1, guard, 80 * 10 ** 9):
            monkeypatch.setattr(jet, "_device_hbm_limit", lambda: limit)
            monkeypatch.setattr(et, "_device_hbm_limit", lambda device=None: limit)
            for env in ("", "1"):
                monkeypatch.setenv("MADELEINE_ENCODER_NO_SAVE_ACTS", env)
                for save_acts in (None, True, False):
                    want = jet._resolve_save_acts(save_acts, *shape, x_bytes=x_bytes)
                    got = et.resolve_save_acts(save_acts, *shape, x_bytes=x_bytes)
                    assert got is want, (budget, limit, env, save_acts)
                    seen.add(got)
    assert seen == {True, False}


# ---------------------------------------------------------------------------
# the encoder op's recompute route
# ---------------------------------------------------------------------------

B, T, D, NH, E = 2, 96, 128, 2, 128


def _loss_torch(pooled, tok):
    return torch.sin(pooled).sum() + (torch.cos(tok) * 0.01).sum()


@pytest.mark.parametrize("need_dx", [False, True], ids=["no_dx", "dx"])
def test_plain_recompute_route_equals_save_route_and_jax(need_dx):
    """The op at rates 0 with a ragged mask (one bag 41 of 96 tokens):
    save_acts False (the plain backward rebuilds the residuals by the
    forward's own function) gives the save route's pooled, tokens and
    every gradient (and dx) bit for bit, and both match JAX's
    encoder_train(..., save_acts=False) in interpret mode at
    test_torch_encoder_train.py's bars."""
    from madeleine_tpu.ops.encoder_train import encoder_train as jax_op

    _, _, params, model = param_pair(seed=1, patch_embedding_dim=D, wsi_encoder_hidden_dim=E,
                                     n_heads=NH, attention_hidden_dim=E)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    mask = ragged_mask([96, 41], T)

    def jax_loss(x, pre, attn, tokp):
        p, tk = jax_op(x, pre, attn, tokp, jnp.asarray(mask), jnp.int32(7), 0.0, 0.0, 32,
                       need_dx, False)
        return jnp.sum(jnp.sin(p)) + jnp.sum(jnp.cos(tk) * 0.01), (p, tk)

    emb = params["wsi_embedders"]
    (_, (jp, jtk)), jg = jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3), has_aux=True)(
        jnp.asarray(x), emb["pre_attn"], emb["attn"], params["token_projector"])
    want_g = grads_as_state_dict({"wsi_embedders": {"pre_attn": jg[1], "attn": jg[2]},
                                  "token_projector": jg[3]}, params)
    out = {}
    for save in (True, False):
        model.zero_grad()
        xt = to_torch(x).requires_grad_(need_dx)
        pooled, tok = et.encoder_train(xt, torch.from_numpy(mask),
                                       train_weights(model, torch.float32), 7, 0.0, 0.0,
                                       need_dx=need_dx, save_acts=save)
        _loss_torch(pooled, tok).backward()
        grads = {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}
        if need_dx:
            grads["x"] = xt.grad
        out[save] = (pooled.detach(), tok.detach(), grads)
    (ps, ts, gs), (pr, tr, gr) = out[True], out[False]
    assert torch.equal(ps, pr) and torch.equal(ts, tr)
    assert gs.keys() == gr.keys() and all(torch.equal(gs[k], gr[k]) for k in gs)
    np.testing.assert_allclose(pr.numpy(), np.asarray(jp), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jtk), rtol=1e-4, atol=1e-5)
    want_g = {k: v.numpy() for k, v in want_g.items()}
    if need_dx:
        want_g["x"] = np.asarray(jg[0])
    for k, g in gr.items():
        ref = want_g[k]
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-4, atol=1e-5 * scale, err_msg=k)


def test_the_environment_variable_sends_every_call_to_the_recompute_route(monkeypatch):
    """MADELEINE_ENCODER_NO_SAVE_ACTS set: the autograd graph keeps no
    residual (the backward rebuilds them), and the gradients are the save
    route's bit for bit."""
    _, _, _, model = param_pair(seed=2, patch_embedding_dim=D, wsi_encoder_hidden_dim=E,
                                n_heads=NH, attention_hidden_dim=E)
    x = to_torch(np.random.default_rng(1).standard_normal((B, 40, D)))
    grads, kept = [], []
    for env in ("", "1"):
        monkeypatch.setenv("MADELEINE_ENCODER_NO_SAVE_ACTS", env)
        model.zero_grad()
        pooled, tok = et.encoder_train(x, None, train_weights(model, torch.float32), 3)
        kept.append(len(pooled.grad_fn.saved_tensors))
        _loss_torch(pooled, tok).backward()
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()
                      if p.grad is not None})
    assert kept[0] - kept[1] == len(et.SAVED)
    assert all(torch.equal(grads[0][k], grads[1][k]) for k in grads[0])


# ---------------------------------------------------------------------------
# the ragged train step against JAX's
# ---------------------------------------------------------------------------

STEP_CFG = dict(local_loss="got", got_subsample=8, temperature=0.001, lr=1e-4, warmup=False,
                max_epochs=3, weight_decay=0.01, symmetric_cl=True)


@pytest.fixture
def rates_zero(monkeypatch):
    monkeypatch.setattr(et, "PRE_RATE", 0.0)
    monkeypatch.setattr(et, "GATE_RATE", 0.0)


def _ragged_step_batch(rng, bs=6, n_mod=3, t=16):
    """A ragged batch: bag lengths 5-16 of t = 16, bag (1, 2) all masked with
    label 0 (a missing stain), padding poisoned (the mask must hide it)."""
    batch = train_batch(rng, bs=bs, n_mod=n_mod, t=t, d=64)
    batch["modality_labels"][:] = 1.0
    lengths = rng.integers(5, t + 1, (bs, n_mod))
    lengths[1, 2] = 0
    batch["modality_labels"][1, 2] = 0.0
    batch["token_mask"] = np.arange(t)[None, None, :] < lengths[..., None]
    batch["feats"][~batch["token_mask"]] = 7.0
    return batch


def _jax_got_noise(rng_key, n_mod, bs, t):
    """The Gumbel noise JAX's step draws for its ragged GOT subsample
    (trainer.py:129-150, losses.py:278-283, single device): the loss key
    of the step's key, split per modality, then per side."""
    _, loss_rng = jax.random.split(rng_key)
    got_rngs = jax.random.split(loss_rng, n_mod)
    rows = jnp.zeros((), jnp.int32) + jnp.arange(bs)
    out = np.zeros((n_mod - 1, 2, bs, t), np.float32)
    for s, stain_idx in enumerate(range(1, n_mod)):
        for side, key in enumerate(jax.random.split(got_rngs[stain_idx])):
            keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(rows)
            out[s, side] = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (t,)))(keys))
    return out


def test_ragged_train_steps_match_jax(monkeypatch, rates_zero):
    """Two f32 InfoNCE + GOT steps at rates 0 on a ragged batch with an
    all-masked stain bag, the port handed JAX's GOT noise (got_subsample 8
    of 16: the masked per-side draw matters): losses at rtol 1e-4, the first
    step's gradients at 1e-4 relative Frobenius (each attention_c bias, an
    exact 0, within 1e-4), the parameters after each step within 5% of lr
    (2.05 lr for those biases), as tests/test_torch_train.py's GOT test;
    the forward's slide embeddings equal JAX's but for the all-masked bag,
    which the port pools to 0 and JAX's fused kernel near-uniformly. Adam's
    first steps move an element by about lr times the sign of its gradient,
    so an element whose gradient lies within 4 times its tensor's RMS
    difference between the two sides (the rounding floor, where the sign
    is noise) may move up to 2.05 lr apart, as each attention_c bias."""
    monkeypatch.setenv("MADELEINE_FORCE_FUSED", "1")
    monkeypatch.setenv("MADELEINE_NO_GOT_GLUE", "1")
    jcfg, pcfg, params, model = param_pair(**STEP_CFG)
    batch = _ragged_step_batch(np.random.default_rng(5))
    bs, n_mod, t, _ = batch["feats"].shape
    # the forwards: equal but for the masked bag's slide embedding
    jslide, _ = mtm.forward_train(jax.tree_util.tree_map(jnp.asarray, params), jcfg,
                                  jnp.asarray(batch["feats"]),
                                  mask=jnp.asarray(batch["token_mask"]), n_views=1, train=True,
                                  rng=jax.random.PRNGKey(0))
    with torch.no_grad():
        slide, _ = forward_train(model, to_torch(batch["feats"]),
                                 mask=torch.from_numpy(batch["token_mask"]))
    jslide = np.asarray(jslide)
    keep = np.ones((bs, n_mod), bool)
    keep[1, 2] = False
    np.testing.assert_allclose(slide.numpy()[keep], jslide[keep], rtol=1e-4, atol=1e-5)
    assert np.abs(slide.numpy()[1, 2] - jslide[1, 2]).max() > 1e-3
    # the steps
    tx, _ = jax_optim.make_optimizer(jcfg, steps_per_epoch=10)
    state = jax_trainer.init_train_state(jax.tree_util.tree_map(jnp.asarray, params), tx)
    jstep = jax_trainer.make_train_step(jcfg, tx, donate=False)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        drop_rng, loss_rng = jax.random.split(jax.random.PRNGKey(0))
        s, tk = mtm.forward_train(p, jcfg, jb["feats"], mask=jb["token_mask"], n_views=1,
                                  rng=drop_rng, train=True)
        return jax_trainer.compute_losses(jcfg, s.astype(jnp.float32), tk, jb["modality_labels"],
                                          jb["sample_mask"], loss_rng,
                                          token_mask=jb["token_mask"])[0]

    want_grads = grads_as_state_dict(jax.grad(loss_fn)(state.params), params)
    model.train()
    opt, sched = make_optimizer(pcfg, model.parameters(), steps_per_epoch=10)
    step = make_train_step(pcfg, model, opt, sched)
    noise_only = lambda k: k.endswith("attention_c.bias")
    lr = pcfg.lr
    floor = {}
    for i in range(2):
        state, _, jm = jstep(state, jb, jax.random.PRNGKey(i))
        want_params = jax.tree_util.tree_map(np.asarray, state.params)
        _, metrics = step(dict(batch, got_gumbel=torch.from_numpy(
            _jax_got_noise(jax.random.PRNGKey(i), n_mod, bs, t))), seed=i)
        assert not metrics["skipped"] and not bool(jm["skipped"])
        np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]), rtol=1e-4)
        if i == 0:
            for k, p in model.named_parameters():
                ref = want_grads[k]
                if noise_only(k):
                    assert float((p.grad - ref).abs().max()) <= 1e-4, k
                else:
                    assert float((p.grad - ref).norm() / ref.norm()) < 1e-4, k
                rms = (p.grad - ref).norm() / p.numel() ** 0.5
                floor[k] = (torch.ones_like(ref, dtype=torch.bool) if noise_only(k)
                            else ref.abs() <= 4 * rms)
        want_sd = params_from_jax(want_params)
        for k, p in model.state_dict().items():
            diff = (p - want_sd[k]).abs()
            bar = torch.where(floor[k], 2.05, 0.05) if k in floor else torch.full_like(diff, .05)
            assert (diff <= bar * lr * (i + 1)).all(), (i, k, float(diff.max()))
    assert int(step.updates) == 2


class _PadPoisoner:
    """A ragged loader whose batches' padding holds `value`: if the mask
    reaches every use of the tokens, the value is invisible."""

    def __init__(self, loader, value):
        self.loader, self.value = loader, value

    def __iter__(self):
        for batch in self.loader:
            feats = batch["feats"].copy()
            feats[~batch["token_mask"]] = self.value
            yield dict(batch, feats=feats)


def test_train_loop_on_the_ragged_loader_is_padding_invariant(tmp_path):
    """SlideDataset(sample=-1) -> RaggedTrainLoader -> train_loop, InfoNCE +
    GOT with dropout on: padding poisoned with 1e6 gives the clean run's
    losses and parameters bit for bit (tests/test_train.py:231); the
    records carry each step's bucket and its valid tokens."""
    csv_path, feats = _write_cohort(str(tmp_path), _ragged_lengths(5), d=64)
    results = []
    for poison in (0.0, 1e6):
        _, pcfg, _, model = param_pair(**dict(STEP_CFG, temperature=0.1))
        model.train()
        opt, sched = make_optimizer(pcfg, model.parameters(), steps_per_epoch=3)
        step = make_train_step(pcfg, model, opt, sched)
        ds = PD.SlideDataset("ACROBAT", csv_path, feats, pcfg.MODALITIES, embedding_size=64,
                            sample=-1)
        loader = PD.RaggedTrainLoader(ds, batch_size=2, buckets=(64,), seed=3)
        loader.set_epoch(0)
        loss, rank, agg = train_loop(pcfg, step, _PadPoisoner(loader, poison), 0, seed=11)
        assert np.isfinite(loss) and loss > 0 and agg["n_steps"] + agg["n_skipped"] == 3
        results.append((loss, [s["loss"] for s in agg["steps"]],
                        {k: v.clone() for k, v in model.state_dict().items()}, agg["steps"]))
    (la, sa, pa, steps), (lb, sb, pb, _) = results
    assert la == lb and sa == sb
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert sorted({s["bucket"] for s in steps}) == [64, 128]
    assert all(s["valid_tokens"] > 0 for s in steps)
