"""The port's pre-attention train op (madeleine_torch/ops/preattn.py, kernels
15/16 on the card) against the JAX package's `preattn_train` (its Pallas
kernels in interpret mode on the CPU, rate 0), and at the reference rate
0.1 against itself: forward and backward masks, the keep rate, finite
differences in float64, and the masks of the whole-encoder op K6/K7."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madeleine_torch.models.madeleine import train_weights
from madeleine_torch.ops import encoder_train as et
from madeleine_torch.ops import preattn as pa
from madeleine_torch.ops import prng
from madeleine_torch.ops.linear_tok import linear_tok_fwd_plain
from tests.torch_port_helpers import grads_as_state_dict, param_pair, to_torch

B, T, D, NH, E = 2, 96, 64, 2, 64
T_BLOCK = 32
SEED = 11


@pytest.fixture(scope="module")
def setup():
    _, _, params, model = param_pair(seed=2, patch_embedding_dim=D, wsi_encoder_hidden_dim=E,
                                     n_heads=NH, attention_hidden_dim=E)
    x = np.random.default_rng(0).standard_normal((B, T, D)).astype(np.float32)
    return params, model, x


def _jax_op(params, x):
    from madeleine_tpu.ops.preattn import preattn_train

    def loss(xj, pre):
        y = preattn_train(xj, pre, jnp.int32(SEED), 0.0, T_BLOCK)
        return jnp.sum(jnp.sin(y)), y

    pre = params["wsi_embedders"]["pre_attn"]
    (_, y), (gx, gpre) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), pre)
    gsd = grads_as_state_dict({"wsi_embedders": {"pre_attn": gpre}}, params)
    return np.asarray(y), np.asarray(gx), gsd


def _port_op(model, x, rate=0.0):
    model.zero_grad()
    xt = to_torch(x).requires_grad_(True)
    y = pa.preattn_train(xt, train_weights(model, torch.float32), SEED, 0, rate)
    torch.sin(y).sum().backward()
    grads = {k: p.grad for k, p in model.named_parameters() if p.grad is not None}
    return y.detach().numpy(), xt.grad.numpy(), grads


@pytest.mark.parametrize("case", ["full", "partial_t"])
def test_matches_jax_values_and_gradients(setup, case):
    """y at rtol 1e-5 / atol 1e-5; dx and the 12 parameter gradients at rtol
    1e-4, atol 1e-5 x the largest entry (sums over up to 192 tokens in
    another order than XLA's). partial_t: t = 41, no multiple of the JAX
    t_block (its padded rows must not reach the gradients)."""
    params, model, x = setup
    if case == "partial_t":
        x = x[:, :41]
    want_y, want_dx, want_g = _jax_op(params, x)
    got_y, got_dx, got_g = _port_op(model, x)
    np.testing.assert_allclose(got_y, want_y, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_dx, want_dx, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want_dx).max()))
    assert set(got_g) == {k for k in want_g if k.startswith("wsi_embedders.pre_attn")}
    assert len(got_g) == 12
    for k, g in got_g.items():
        ref = want_g[k].numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(np.abs(ref).max())), err_msg=k)


def _operands(model, dtype):
    return {k: v.detach().to(dtype) for k, v in train_weights(model, torch.float32).items()}


def test_explicit_backward_equals_autograd_at_the_reference_rate(setup):
    """At rate 0.1 the backward regenerates the forward's masks: the explicit
    adjoint (which recomputes the stack from x and the seed) equals autograd
    through the plain forward with a random cotangent, row_offset 5 included,
    at rtol 1e-4 / atol 1e-5 x the largest entry; dx as well."""
    _, model, x = setup
    w = _operands(model, torch.float32)
    wg = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    xt = to_torch(x).requires_grad_(True)
    dy = to_torch(np.random.default_rng(4).standard_normal((B, T, NH * E)))
    with torch.enable_grad():
        y = pa.preattn_fwd_plain(xt, wg, SEED, 5, pa.RATE)
        (y * dy).sum().backward()
    got = pa.preattn_bwd_plain(xt.detach(), dy, w, SEED, 5, pa.RATE, need_dx=True)
    for k in pa.KEYS + ("x",):
        ref = xt.grad if k == "x" else wg[k].grad
        torch.testing.assert_close(got[k], ref, rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(ref.abs().max())), msg=k)


def test_masks_keep_rate_and_dropped_sites(setup):
    """Each layer's mask keeps 1 - 0.1 of its sites within 3 sigma; the
    layer-3 sites the forward dropped are exactly where y is 0; dropout
    changes the output."""
    _, model, x = setup
    w = _operands(model, torch.float32)
    xt = to_torch(x)
    y = pa.preattn_fwd_plain(xt, w, SEED, 0, pa.RATE)
    assert not torch.equal(y, pa.preattn_fwd_plain(xt, w, SEED, 0, 0.0))
    rows, toks = prng.site_rows(B, T, 0, "cpu")
    for layer, width in ((0, E), (1, E), (2, NH * E)):
        keep = prng.keep_mask(SEED, rows, toks, layer, width, pa.RATE) > 0
        n = keep.numel()
        frac = float(keep.float().mean())
        assert abs(frac - 0.9) < 3 * np.sqrt(0.9 * 0.1 / n), (layer, frac)
    assert torch.equal(y == 0, ~keep)


def test_finite_differences_in_float64(setup):
    """Directional derivatives of <y, R> by central differences (float64,
    eps 1e-6, rate 0.1 with fixed masks) against the explicit backward, for
    x and every operand, at rtol 1e-6."""
    _, model, x = setup
    w = _operands(model, torch.float64)
    xt = to_torch(x[:1, :24], torch.float64)
    rng = np.random.default_rng(6)
    R = torch.from_numpy(rng.standard_normal((1, 24, NH * E)))
    grads = pa.preattn_bwd_plain(xt, R, w, SEED, 3, pa.RATE, need_dx=True)

    def f(xv, wv):
        return float((pa.preattn_fwd_plain(xv, wv, SEED, 3, pa.RATE) * R).sum())

    eps = 1e-6
    for k in ("x",) + pa.KEYS:
        base = xt if k == "x" else w[k]
        d = torch.from_numpy(rng.standard_normal(base.shape))
        if k == "x":
            fd = (f(xt + eps * d, w) - f(xt - eps * d, w)) / (2 * eps)
        else:
            fd = (f(xt, dict(w, **{k: w[k] + eps * d})) - f(xt, dict(w, **{k: w[k] - eps * d}))) \
                / (2 * eps)
        an = float((grads[k] * d).sum())
        assert abs(fd - an) <= 1e-6 * max(1.0, abs(an)), (k, fd, an)


def test_masks_equal_the_whole_encoder_ops(setup):
    """For the same (seed, row_offset) at rates (0.1, 0.25), the token
    projector applied to this op's output is K6's plain version's tok,
    bit for bit: its three layer masks are K6/K7's."""
    _, model, x = setup
    w = _operands(model, torch.float32)
    xt = to_torch(x)
    bias = et.token_mask_bias(None, B, T, "cpu")
    tok_k6 = et.encoder_train_fwd_plain(xt, bias, w, SEED, 7, pa.RATE, 0.25)[3]
    y = pa.preattn_fwd_plain(xt, w, SEED, 7, pa.RATE)
    assert torch.equal(linear_tok_fwd_plain(y, w["wt"], w["bt"]), tok_k6)
    other = pa.preattn_fwd_plain(xt, w, SEED, 8, pa.RATE)
    assert not torch.equal(other, y)
