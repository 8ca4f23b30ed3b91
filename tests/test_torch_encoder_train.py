"""The port's whole-encoder train op (madeleine_torch/ops/encoder_train.py)
against the JAX package's `encoder_train` (interpret mode on the CPU, rates
0, save_acts route) and against autograd through its own plain forward at
the reference dropout rates. f32 throughout: the point here is the algorithm;
the bf16 kernels are held against these plain versions on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madeleine_torch.models.madeleine import train_weights
from madeleine_torch.ops import encoder_train as et
from tests.torch_port_helpers import grads_as_state_dict, param_pair, to_torch

B, T, D, NH, E = 2, 96, 128, 2, 128
T_BLOCK = 32
SEED = 7


@pytest.fixture(scope="module")
def setup():
    jcfg, pcfg, params, model = param_pair(seed=1, patch_embedding_dim=D,
                                           wsi_encoder_hidden_dim=E, n_heads=NH,
                                           attention_hidden_dim=E)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    mask = rng.random((B, T)) < 0.8
    return params, model, x, mask


def _loss_jax(pooled, tok):
    return jnp.sum(jnp.sin(pooled)) + jnp.sum(jnp.cos(tok) * 0.01)


def _loss_torch(pooled, tok):
    return torch.sin(pooled).sum() + (torch.cos(tok) * 0.01).sum()


def _jax_op(params, x, mask, t_block=T_BLOCK):
    from madeleine_tpu.ops.encoder_train import encoder_train

    def f(pre, attn, tokp):
        p, tk = encoder_train(jnp.asarray(x), pre, attn, tokp,
                              None if mask is None else jnp.asarray(mask), jnp.int32(SEED),
                              0.0, 0.0, t_block, False, True)
        return _loss_jax(p, tk), (p, tk)

    emb = params["wsi_embedders"]
    (_, (p, tk)), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        emb["pre_attn"], emb["attn"], params["token_projector"])
    gsd = grads_as_state_dict({"wsi_embedders": {"pre_attn": grads[0], "attn": grads[1]},
                               "token_projector": grads[2]}, params)
    return np.asarray(p), np.asarray(tk), gsd


def _port_op(model, x, mask):
    model.zero_grad()
    w = train_weights(model, torch.float32)
    pooled, tok = et.encoder_train(to_torch(x), None if mask is None else torch.from_numpy(mask),
                                   w, SEED, 0.0, 0.0)
    _loss_torch(pooled, tok).backward()
    grads = {k: p.grad for k, p in model.named_parameters() if p.grad is not None}
    return pooled.detach().numpy(), tok.detach().numpy(), grads


@pytest.mark.parametrize("case", ["dense", "ragged", "partial_t"])
def test_op_matches_jax_values_and_gradients(setup, case):
    """pooled, tok and all 20 gradients at rtol 1e-4; atol 1e-5 scaled by the
    gradient's largest entry (sums over 192 tokens of products of O(1)
    terms, accumulated in another order than XLA's)."""
    params, model, x, mask = setup
    if case == "dense":
        mask = None
    elif case == "partial_t":
        x, mask = x[:1, :41], None          # t not a multiple of the JAX t_block
    want_p, want_t, want_g = _jax_op(params, x, mask)
    got_p, got_t, got_g = _port_op(model, x, mask)
    np.testing.assert_allclose(got_p, want_p, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_t, want_t, rtol=1e-4, atol=1e-5)
    assert set(got_g) == {k for k in want_g if not k.startswith("projector")}
    for k, g in got_g.items():
        ref = want_g[k].numpy()
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-4, atol=1e-5 * scale, err_msg=k)


def _plain_inputs(model, x, mask, dtype=torch.float32):
    w = {k: v.detach() for k, v in train_weights(model, dtype).items()}
    xt = to_torch(x).to(dtype)
    bias = et.token_mask_bias(torch.from_numpy(mask), *x.shape[:2], "cpu")
    return w, xt, bias


def test_plain_bwd_equals_autograd_through_plain_fwd_at_real_rates(setup):
    """The explicit adjoint against autograd through the plain forward, with
    the reference rates (0.1, 0.25) and the same masks, a random pooled
    cotangent and a random dtok; rtol 1e-4 / atol 1e-5 x max(1, the largest
    entry). The exact bc gradient is 0 (softmax is shift invariant), so both
    sides give sums of cancelling terms that only the atol can compare."""
    _, model, x, mask = setup
    mask = mask.copy()
    mask[1] = False                                         # a bag with no valid token
    w, xt, bias = _plain_inputs(model, x, mask)
    rng = np.random.default_rng(5)
    wg = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    with torch.enable_grad():
        pooled, m, s, tok, l, saved = et.encoder_train_fwd_plain(xt, bias, wg, SEED, 3)
        G = to_torch(rng.standard_normal(pooled.shape))
        DT = to_torch(rng.standard_normal(tok.shape))
        ((pooled * G).sum() + (tok * DT).sum()).backward()
    assert (pooled[1] == 0).all()
    inner = (G * pooled.detach()).reshape(B, NH, -1).sum(-1)
    got = et.encoder_train_bwd_plain(xt, l.detach(), m.detach(), s.detach(), G, inner, DT,
                                     {k: v.detach() for k, v in saved.items()}, w, SEED, 3)
    for k in et.W_KEYS:
        ref = wg[k].grad
        scale = max(1.0, float(ref.abs().max()))
        torch.testing.assert_close(got[k], ref, rtol=1e-4, atol=1e-5 * scale, msg=k)


def test_forward_dropout_sites_are_the_backward_masks(setup):
    """At the real rates, the layer-3 sites the forward dropped (y32 == 0) are
    exactly where the backward's regenerated mask is 0; and dropout changes
    the output (the masks are live)."""
    _, model, x, mask = setup
    w, xt, bias = _plain_inputs(model, x, mask)
    p_drop, *_, saved = et.encoder_train_fwd_plain(xt, bias, w, SEED, 0)
    p_keep = et.encoder_train_fwd_plain(xt, bias, w, SEED, 0, 0.0, 0.0)[0]
    assert not torch.allclose(p_drop, p_keep)
    u3 = saved["u3"]
    v3 = u3 * w["s3"] + w["t3"]
    rows, toks = et.prng.site_rows(B, T, 0, "cpu")
    keep = et.prng.keep_mask(SEED, rows, toks, 2, NH * E, et.PRE_RATE)
    y32 = v3 * et._cdf(v3) * keep
    assert torch.equal(y32 == 0, keep == 0)
    assert 0.05 < float((keep == 0).float().mean()) < 0.15
