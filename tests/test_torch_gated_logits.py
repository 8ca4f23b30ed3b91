"""The port's gate-logits train op (madeleine_torch/ops/gated_logits.py,
kernels 17/18 on the card) against the JAX package's `gated_logits_train`
(its Pallas kernels in interpret mode on the CPU, rate 0), and at the
reference rate 0.25 against itself: forward and backward masks, the keep
rate, finite differences in float64, and the masks of the whole-encoder op
K6/K7."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madeleine_torch.models.madeleine import train_weights
from madeleine_torch.ops import encoder_train as et
from madeleine_torch.ops import gated_logits as gl
from madeleine_torch.ops import preattn as pa
from madeleine_torch.ops import prng
from tests.torch_port_helpers import grads_as_state_dict, param_pair, to_torch

B, T, D, NH, E, F = 2, 80, 64, 2, 64, 32
T_BLOCK = 32
SEED = 13


@pytest.fixture(scope="module")
def setup():
    _, _, params, model = param_pair(seed=3, patch_embedding_dim=D, wsi_encoder_hidden_dim=E,
                                     n_heads=NH, attention_hidden_dim=F)
    y = np.random.default_rng(1).standard_normal((B, T, NH * E)).astype(np.float32)
    return params, model, y


def _jax_op(params, y):
    from madeleine_tpu.ops.gated_logits import gated_logits_train

    def loss(yj, attn):
        logits = gated_logits_train(yj, attn, jnp.int32(SEED), 0.0, T_BLOCK)
        return jnp.sum(jnp.sin(3.0 * logits)), logits

    attn = params["wsi_embedders"]["attn"]
    (_, logits), (gy, gattn) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(y), attn)
    gsd = grads_as_state_dict({"wsi_embedders": {"attn": gattn}}, params)
    return np.asarray(logits), np.asarray(gy), gsd


def _port_op(model, y, rate=0.0):
    model.zero_grad()
    yt = to_torch(y).requires_grad_(True)
    logits = gl.gated_logits_train(yt, train_weights(model, torch.float32), SEED, 0, rate)
    torch.sin(3.0 * logits).sum().backward()
    grads = {k: p.grad for k, p in model.named_parameters() if p.grad is not None}
    return logits.detach().numpy(), yt.grad.numpy(), grads


@pytest.mark.parametrize("case", ["full", "partial_t"])
def test_matches_jax_values_and_gradients(setup, case):
    """logits at rtol 1e-5 / atol 1e-5; dy and the gradients of every gate
    parameter (Wa, ba, Wb, bb, wc and bc, the sum of the logits' cotangent
    taken outside the kernel) at rtol 1e-4, atol 1e-5 x the largest entry.
    partial_t: t = 41, no multiple of the JAX t_block."""
    params, model, y = setup
    if case == "partial_t":
        y = y[:, :41]
    want_l, want_dy, want_g = _jax_op(params, y)
    got_l, got_dy, got_g = _port_op(model, y)
    assert got_l.dtype == np.float32 and got_l.shape == (y.shape[0], y.shape[1], NH)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_dy, want_dy, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want_dy).max()))
    assert set(got_g) == {k for k in want_g if ".attn." in k}
    assert len(got_g) == 6 * NH
    for k, g in got_g.items():
        ref = want_g[k].numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(np.abs(ref).max())), err_msg=k)


def _operands(model, dtype):
    return {k: v.detach().to(dtype) for k, v in train_weights(model, torch.float32).items()}


def test_explicit_backward_equals_autograd_at_the_reference_rate(setup):
    """At rate 0.25 the backward (which recomputes the gates from y and the
    seed) regenerates the forward's masks: it equals autograd through the
    plain forward with a random cotangent, row_offset 9 included, at rtol
    1e-4 / atol 1e-5 x the largest entry."""
    _, model, y = setup
    w = _operands(model, torch.float32)
    wg = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    yt = to_torch(y).requires_grad_(True)
    dl = to_torch(np.random.default_rng(4).standard_normal((B, T, NH)))
    with torch.enable_grad():
        logits = gl.gated_logits_fwd_plain(yt, wg, SEED, 9, gl.RATE)
        (logits * dl).sum().backward()
    got = gl.gated_logits_bwd_plain(yt.detach(), dl, w, SEED, 9, gl.RATE)
    for k in gl.KEYS + ("y",):
        ref = yt.grad if k == "y" else wg[k].grad
        torch.testing.assert_close(got[k], ref, rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(ref.abs().max())), msg=k)


def test_keep_rate_and_live_masks(setup):
    """Each gate branch's mask keeps 1 - 0.25 of its sites within 3 sigma,
    and dropout changes the logits."""
    _, model, y = setup
    w = _operands(model, torch.float32)
    yt = to_torch(y)
    assert not torch.equal(gl.gated_logits_fwd_plain(yt, w, SEED, 0, gl.RATE),
                           gl.gated_logits_fwd_plain(yt, w, SEED, 0, 0.0))
    rows, toks = prng.site_rows(B, T, 0, "cpu")
    for branch in (0, 1):
        keep = gl.gate_masks(SEED, rows, toks, NH, F, branch, gl.RATE) > 0
        frac = float(keep.float().mean())
        assert abs(frac - 0.75) < 3 * np.sqrt(0.75 * 0.25 / keep.numel()), (branch, frac)


def test_finite_differences_in_float64(setup):
    """Directional derivatives of <logits, R> by central differences
    (float64, eps 1e-6, rate 0.25 with fixed masks) against the explicit
    backward, for y and every operand, at rtol 1e-6."""
    _, model, y = setup
    w = _operands(model, torch.float64)
    yt = to_torch(y[:1, :24], torch.float64)
    rng = np.random.default_rng(7)
    R = torch.from_numpy(rng.standard_normal((1, 24, NH)))
    grads = gl.gated_logits_bwd_plain(yt, R, w, SEED, 2, gl.RATE)

    def f(yv, wv):
        return float((gl.gated_logits_fwd_plain(yv, wv, SEED, 2, gl.RATE) * R).sum())

    eps = 1e-6
    for k in ("y",) + gl.KEYS:
        base = yt if k == "y" else w[k]
        d = torch.from_numpy(rng.standard_normal(base.shape))
        if k == "y":
            fd = (f(yt + eps * d, w) - f(yt - eps * d, w)) / (2 * eps)
        else:
            fd = (f(yt, dict(w, **{k: w[k] + eps * d})) - f(yt, dict(w, **{k: w[k] - eps * d}))) \
                / (2 * eps)
        an = float((grads[k] * d).sum())
        assert abs(fd - an) <= 1e-6 * max(1.0, abs(an)), (k, fd, an)


def test_masks_equal_the_whole_encoder_ops(setup):
    """For the same (seed, row_offset) at rates (0.1, 0.25), this op's logits
    on the pre-attention op's output plus the mask bias are K6's plain
    version's logits, bit for bit: its gate masks are K6/K7's."""
    _, model, _ = setup
    w = _operands(model, torch.float32)
    x = to_torch(np.random.default_rng(2).standard_normal((B, T, D)))
    mask = torch.arange(T)[None, :] < torch.tensor([[T], [50]])
    bias = et.token_mask_bias(mask, B, T, "cpu")
    l_k6 = et.encoder_train_fwd_plain(x, bias, w, SEED, 4, pa.RATE, gl.RATE)[4]
    y = pa.preattn_fwd_plain(x, w, SEED, 4, pa.RATE)
    assert torch.equal(gl.gated_logits_fwd_plain(y, w, SEED, 4, gl.RATE) + bias[..., None],
                       l_k6)
