"""The port's second published run and its eval forward, f32 on the CPU:

- `forward_train(train=False)` (JAX madeleine.py:309-318) against the golden
  fixtures `fs/train/*` and `se/train/*` and the live JAX eval forward, on
  the route CPU tensors take and on the route CUDA tensors take (kernel K3's
  softmax pool, whose plain version runs here);
- `encode` with stain encodings against `se/eval/{3,1}`;
- stain encodings in training (`--add_stain_encoding`): the train forward
  at dropout rates 0 and two AdamW steps against the JAX package, the stain
  table's gradient and update included, on the scan and the joint route;
- the input gradient of the train op (K7's need_dx route) against autograd;
- the pretrain CLI with the flag: strict `model.pt`, exact resume.

Bar of the forwards: rtol 1e-4 / atol 1e-5 (tests/test_golden.py)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madeleine_tpu.models import madeleine as mtm
from madeleine_torch.cli import pretrain
from madeleine_torch.config import MadeleineConfig
from madeleine_torch.models import abmil
from madeleine_torch.models import madeleine as port
from madeleine_torch.models.factory import create_model
from madeleine_torch.ops import attn_pool as ap
from madeleine_torch.ops import encoder_train as et
from madeleine_torch.train import checkpoint as ckpt
from madeleine_torch.train.optim import make_optimizer
from madeleine_torch.train.trainer import make_train_step
from tests.test_torch_pretrain import _argv, _write_cohort
from tests.test_torch_train import STEP_CFG, _jax_run, rates_zero  # noqa: F401 (fixture)
from tests.torch_port_helpers import (GOLDEN_DIR, flagship_model, grads_as_state_dict,
                                      kernel_route_encode, param_pair, ragged_mask, to_torch,
                                      train_batch)

TOL = dict(rtol=1e-4, atol=1e-5)   # tests/test_golden.py's bar


@pytest.fixture(scope="module")
def gold():
    return np.load(os.path.join(GOLDEN_DIR, "golden_flagship.npz"))


@pytest.fixture(params=["plain", "k3"])
def pool_route(request, monkeypatch):
    """'plain': the softmax pool CPU tensors take (`masked_attention_pool`);
    'k3': the route CUDA tensors take, K3's op `softmax_pool`, which runs its
    plain version `softmax_pool_plain` on a CPU tensor."""
    if request.param == "k3":
        def k3_route(xh, logits, mask=None, activation="softmax"):
            assert activation == "softmax"
            return ap.softmax_pool(xh, logits, mask)
        monkeypatch.setattr(abmil, "masked_attention_pool", k3_route)
    return request.param


@pytest.mark.parametrize("prefix", ["fs", "se"])
def test_eval_forward_matches_golden(gold, pool_route, prefix):
    """forward_train(train=False) and forward_train_dict in eval mode at the
    published widths (5 stains, 4 heads, 512-d) against the reference model's
    activations; `se` with stain encodings (d_in 544, bs 1)."""
    model = flagship_model(stain_encoding=prefix == "se").eval()
    feats = to_torch(gold[f"{prefix}/train/in"])
    slide, tok = port.forward_train(model, feats, train=False)
    wsi, toks = port.forward_train_dict(model, feats, train=False)
    for idx, mod in enumerate(model.cfg.MODALITIES):
        want_s, want_t = gold[f"{prefix}/train/wsi/{mod}"], gold[f"{prefix}/train/tok/{mod}"]
        np.testing.assert_allclose(wsi[mod].numpy(), want_s, **TOL, err_msg=mod)
        np.testing.assert_allclose(toks[mod].numpy(), want_t, **TOL, err_msg=mod)
        if mod == "HE":
            want_s, want_t = want_s[..., 0], want_t[..., 0]
        np.testing.assert_allclose(slide[:, idx].numpy(), want_s, **TOL, err_msg=mod)
        np.testing.assert_allclose(tok[:, idx].numpy(), want_t, **TOL, err_msg=mod)


def test_encode_matches_golden_stain_eval(gold):
    """The per-stain eval branch with stain codes 3 and 1 (d_in 544), on the
    plain route and on the route of a CUDA f32 tensor (K2's plain version)."""
    model = flagship_model(stain_encoding=True).eval()
    feats = to_torch(gold["se/eval/in"][:, 0])
    for idx in (3, 1):
        want = gold[f"se/eval/{idx}"].squeeze(1)
        np.testing.assert_allclose(port.encode(model, feats, stain_idx=idx).numpy(), want,
                                   **TOL, err_msg=f"stain {idx}")
        np.testing.assert_allclose(kernel_route_encode(model, feats, stain_idx=idx).numpy(),
                                   want, **TOL, err_msg=f"stain {idx}, kernel route")


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("se", [False, True], ids=["no_se", "se"])
def test_eval_forward_matches_live_jax_with_ragged_masks(pool_route, se):
    """Small widths, bs 3 with ragged bags (one stain of one case empty):
    the eval forward against JAX's."""
    jcfg, cfg, params, model = param_pair(seed=4, add_stain_encoding=se)
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((3, 3, 40, 64)).astype(np.float32)
    mask = np.stack([ragged_mask([40, 17, 0], 40), ragged_mask([3, 40, 40], 40),
                     ragged_mask([40, 40, 40], 40)], axis=1)         # [bs, n_mod, t]
    js, jt = mtm.forward_train(_jnp(params), jcfg, jnp.asarray(feats), mask=jnp.asarray(mask),
                               n_views=1, train=False)
    slide, tok = port.forward_train(model, to_torch(feats), mask=torch.from_numpy(mask),
                                    train=False)
    np.testing.assert_allclose(slide.numpy(), np.asarray(js), **TOL)
    np.testing.assert_allclose(tok.numpy(), np.asarray(jt), **TOL)


@pytest.mark.parametrize("scan", [True, False], ids=["scan", "joint"])
def test_stain_encoded_train_forward_matches_jax(monkeypatch, rates_zero, scan):
    """The train forward with stain encodings at dropout rates 0 against JAX's
    fused route (interpret mode, rates 0 there) and against the port's own
    eval forward. bs 4 != 1, so a code given to the wrong rows (the
    reference's mod-major ids) would show."""
    monkeypatch.setenv("MADELEINE_FORCE_FUSED", "1")
    jcfg, cfg, params, model = param_pair(seed=5, add_stain_encoding=True, modality_scan=scan)
    feats = train_batch(np.random.default_rng(5), bs=4, n_mod=3, t=16, d=64)["feats"]
    js, jt = mtm.forward_train(_jnp(params), jcfg, jnp.asarray(feats), n_views=1,
                               rng=jax.random.PRNGKey(0), train=True)
    with torch.no_grad():
        slide, tok = port.forward_train(model, to_torch(feats), seed=0)
    np.testing.assert_allclose(slide.numpy(), np.asarray(js), **TOL)
    np.testing.assert_allclose(tok.numpy(), np.asarray(jt), **TOL)
    es, etok = port.forward_train(model, to_torch(feats), train=False)
    np.testing.assert_allclose(slide.numpy(), es.numpy(), **TOL)
    np.testing.assert_allclose(tok.numpy(), etok.numpy(), **TOL)


@pytest.mark.parametrize("scan", [True, False], ids=["scan", "joint"])
def test_stain_encoded_train_steps_match_jax(monkeypatch, rates_zero, scan):
    """Two f32 InfoNCE steps with stain encodings at rates 0 against JAX's
    step, with the bars of tests/test_torch_train.py::test_train_steps_match_jax:
    the loss rtol 1e-4; step 1's gradients 1e-4 relative Frobenius per
    tensor, the stain table's included; the parameters after each step,
    the table included, within 1% of the learning rate. The token projector
    (not read by InfoNCE) and the attention_c biases (shift invariance)
    hold exact zeros or rounding noise on both sides; so does any element
    whose step-1 gradient lies at the f32 rounding floor of its tensor
    (below 1e-5 of the tensor's largest; one projector element on the
    joint route here): Adam divides a gradient by its own size, so such an
    element may move by up to lr either way, and it is held to 2.05 lr per
    step as the attention_c biases are."""
    monkeypatch.setenv("MADELEINE_FORCE_FUSED", "1")
    jcfg, pcfg, params, model = param_pair(add_stain_encoding=True, modality_scan=scan,
                                           **STEP_CFG)
    batch = train_batch(np.random.default_rng(6), bs=6, n_mod=3, t=16, d=64)
    want_losses, jgrads, want_params = _jax_run(jcfg, params, batch, 2)
    want_grads = grads_as_state_dict(jgrads, params)
    model.train()
    opt, sched = make_optimizer(pcfg, model.parameters(), steps_per_epoch=10)
    step = make_train_step(pcfg, model, opt, sched)
    lr = pcfg.lr
    table0 = model.embedding.weight.detach().clone()
    noise_only = lambda k: k.endswith("attention_c.bias")
    at_floor = {k: (g.abs() <= 1e-5 * g.abs().max()) | noise_only(k)
                for k, g in want_grads.items()}
    for i in range(2):
        _, metrics = step(batch, seed=i)
        assert not metrics["skipped"]
        np.testing.assert_allclose(float(metrics["loss"]), want_losses[i], rtol=1e-4)
        if i == 0:
            assert model.embedding.weight.grad.abs().max() > 0
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
            diff = (p - want_params[i][k]).abs()
            bar = torch.where(at_floor[k], 2.05, 0.01) * lr * (i + 1)
            assert (diff <= bar).all(), (i, k, float(diff.max()))
    assert not torch.equal(model.embedding.weight, table0)
    assert step.updates == 2


def test_skipped_step_leaves_the_stain_table():
    """An H&E-only batch is skipped: the table and its AdamW state (zero
    moments, as optax.adamw's init makes them; the count 0) untouched."""
    _, pcfg, _, model = param_pair(add_stain_encoding=True, **STEP_CFG)
    opt, sched = make_optimizer(pcfg, model.parameters(), steps_per_epoch=10)
    step = make_train_step(pcfg, model, opt, sched)
    batch = train_batch(np.random.default_rng(7), bs=4, n_mod=3, t=8, d=64, he_only=True)
    table0 = model.embedding.weight.detach().clone()
    _, metrics = step(batch, seed=0)
    st = opt.state[model.embedding.weight]
    assert metrics["skipped"] and step.updates == 0
    assert not st["exp_avg"].any() and not st["exp_avg_sq"].any()
    assert torch.equal(model.embedding.weight, table0)


@pytest.mark.parametrize("rates", [(0.0, 0.0), (0.1, 0.25)], ids=["rates_0", "rates_on"])
def test_plain_dx_matches_autograd_float64(rates):
    """The plain backward's dx (K7's need_dx route; JAX encoder_train.py:
    417-421) and its weight gradients against autograd through the plain
    forward, all in float64 with the same dropout masks. The plain backward
    takes its products in f32, so the bar is 1e-5 relative Frobenius."""
    _, _, _, model = param_pair(seed=8, add_stain_encoding=True)
    w = {k: v.detach().double().requires_grad_(True)
         for k, v in port.train_weights(model, torch.float32).items()}
    rng = np.random.default_rng(8)
    b, t, d_in = 3, 20, model.cfg.input_dim
    x = torch.from_numpy(rng.standard_normal((b, t, d_in))).requires_grad_(True)
    bias = et.token_mask_bias(torch.from_numpy(ragged_mask([20, 11, 1], t)), b, t, "cpu").double()
    seed, ro = 77, 5
    pooled, m, s, tok, l, saved = et.encoder_train_fwd_plain(x, bias, w, seed, ro, *rates)
    g = torch.from_numpy(rng.standard_normal(pooled.shape))
    dtok = torch.from_numpy(rng.standard_normal(tok.shape))
    ((pooled * g).sum() + (tok * dtok).sum()).backward()
    nh, _, e = w["wa"].shape
    inner = (g * pooled.detach()).reshape(b, nh, e).sum(-1)
    grads = et.encoder_train_bwd_plain(x.detach(), l.detach(), m.detach(), s.detach(), g, inner,
                                       dtok, {k: v.detach() for k, v in saved.items()},
                                       {k: v.detach() for k, v in w.items()}, seed, ro, *rates,
                                       need_dx=True)
    assert grads["x"].shape == x.shape and grads["x"].dtype == x.dtype
    for k, want in [("x", x.grad)] + [(k, w[k].grad) for k in et.W_KEYS if k != "bc"]:
        err = float((grads[k].double() - want).norm() / want.norm())
        assert err < 1e-5, (k, err)
    assert "x" not in et.encoder_train_bwd_plain(
        x.detach(), l.detach(), m.detach(), s.detach(), g, inner, dtok,
        {k: v.detach() for k, v in saved.items()}, {k: v.detach() for k, v in w.items()},
        seed, ro, *rates)


def test_table_gradient_is_the_sum_of_dx_over_its_rows(rates_zero):
    """Through the op's autograd: each stain's table gradient is the sum of
    the stain columns of dx over that stain's rows (scan route, row offset
    m*bs), checked against the plain dx."""
    _, cfg, _, model = param_pair(seed=9, add_stain_encoding=True)
    feats = train_batch(np.random.default_rng(9), bs=3, n_mod=3, t=12, d=64)["feats"]
    slide, tok = port.forward_train(model, to_torch(feats), seed=3)
    (slide.float().square().sum() + tok.float().sum()).backward()
    got = model.embedding.weight.grad.clone()
    d = cfg.patch_embedding_dim
    w = {k: v.detach() for k, v in port.train_weights(model, torch.float32).items()}
    for i in range(3):
        x = port._append_stain_encoding(model, to_torch(feats[:, i]), i).detach()
        x.requires_grad_(True)
        pooled, tk = et.encoder_train(x, None, w, 3, row_offset=i * 3, need_dx=True)
        slide_i = port._slide_projection(model, pooled, torch.float32)
        (slide_i.square().sum() + tk.sum()).backward()
        want = x.grad[..., d:].sum((0, 1))
        np.testing.assert_allclose(got[i].numpy(), want.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=f"stain {i}")


def test_pretrain_cli_with_stain_encodings_resumes_exactly(tmp_path):
    """`--add_stain_encoding` end to end on a tiny CPU cohort: model.pt loads
    strictly with `embedding.weight` [5, 32] (d_in 16 + 32), the table moved
    from its initial value, and 1 epoch resumed to 2 equals 2 epochs
    straight bit for bit, the table and its AdamW moments included."""
    root = str(tmp_path)
    _, _, down = _write_cohort(root, 11, 16, lengths=(20, 60), seed=1)
    se = ("--add_stain_encoding",)
    run_a = pretrain.main(_argv(root, os.path.join(root, "a"), 1, "--downstream_dir", down, *se))
    run_b = pretrain.main(_argv(root, os.path.join(root, "b"), 2, "--resume",
                                os.path.join(run_a, "train_state"), *se))
    run_c = pretrain.main(_argv(root, os.path.join(root, "c"), 2, *se))
    sa, sb, sc = (torch.load(os.path.join(r, "model.pt")) for r in (run_a, run_b, run_c))
    assert sb.keys() == sc.keys() and all(torch.equal(sb[k], sc[k]) for k in sb)
    assert sb["embedding.weight"].shape == (5, 32)
    cfg, model = create_model(MadeleineConfig.from_json(os.path.join(run_c, "model_config.json")),
                              checkpoint_path=os.path.join(run_c, "model.pt"), device="cpu")
    assert cfg.add_stain_encoding and cfg.input_dim == 48
    assert model.wsi_embedders.pre_attn[0].weight.shape[1] == 48
    _, init = create_model(cfg, seed=cfg.seed, device="cpu")
    assert not torch.equal(init.embedding.weight, model.embedding.weight)
    assert not torch.equal(sa["embedding.weight"], sc["embedding.weight"])
    tb = ckpt.restore_train_state(os.path.join(run_b, "train_state"))
    tc = ckpt.restore_train_state(os.path.join(run_c, "train_state"))
    ob, oc = tb["optimizer"]["state"], tc["optimizer"]["state"]
    assert ob.keys() == oc.keys()
    for i in ob:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(ob[i][k], oc[i][k]), (i, k)
    assert os.path.exists(os.path.join(run_a, "downstream.pkl"))
