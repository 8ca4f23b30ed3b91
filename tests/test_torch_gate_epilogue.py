"""K6's gate logits in its gate product's epilogue (madeleine_torch/ops/
encoder_train.py::permute_gates, csrc/gemm_wgmma.cuh::epilogue_gates),
mirrored on the CPU: the row permutation of [Wa; Wb] the wrapper applies,
and the epilogue's reduction order (permuted products, 64-column partial
logits summed in chunk order) against the plain forward and against the
JAX package's interpret-mode `_fwd_kernel`. The per-op kernel 17
(csrc/gated_logits.cu::gated_logits_forward) is the same launch with no
residuals and no mask bias: the mirror without a bias against
`gated_logits_fwd_plain` and JAX's interpret-mode gated-logits
`_fwd_kernel`. f32 throughout; the kernels themselves are held against
their plain versions on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madeleine_torch.models.madeleine import train_weights
from madeleine_torch.ops import encoder_train as et
from madeleine_torch.ops import gated_logits as gl
from madeleine_torch.ops import preattn as pa
from madeleine_torch.ops import prng
from tests.torch_port_helpers import param_pair, to_torch

B, T, D, NH, HID, F = 2, 40, 64, 2, 128, 128   # f = 128: two 64-column chunks per head
T_BLOCK = 32
SEED, ROW_OFFSET = 11, 3


@pytest.fixture(scope="module")
def setup():
    _, _, params, model = param_pair(seed=2, patch_embedding_dim=D, wsi_encoder_hidden_dim=HID,
                                     n_heads=NH, attention_hidden_dim=F)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    mask = rng.random((B, T)) < 0.8
    w = {k: v.detach() for k, v in train_weights(model, torch.float32).items()}
    return params, w, x, mask


@pytest.mark.parametrize("f", [128, 512])
def test_gate_perm_is_a_bijection_the_tile_layout_undoes(f):
    """Every row of [Wa; Wb] appears once; permuted row n is the row the
    epilogue reads there: tile n // 128, tanh in its first 64 columns and
    sigmoid in the rest, for column j = 64 (n // 128) + n % 64."""
    perm = et.gate_perm(f)
    assert torch.equal(perm.sort().values, torch.arange(2 * f))
    n = torch.arange(2 * f)
    branch, j = (n % 128) >= 64, 64 * (n // 128) + n % 64
    assert torch.equal(perm, branch * f + j)
    inv = torch.empty_like(perm)
    inv[perm] = n
    assert torch.equal(perm[inv], n)


def test_permute_gates_is_gate_perm_on_rows_and_bias(setup):
    _, w, _, _ = setup
    wab, bab = et.permute_gates(w)
    perm = et.gate_perm(F)
    assert torch.equal(wab, torch.cat([w["wa"], w["wb"]], dim=1)[:, perm])
    assert torch.equal(bab, torch.cat([w["ba"], w["bb"]], dim=1)[:, perm])


def _fused_mirror(y, bias, w, seed, row_offset, gate_rate):
    """The gate product with the permuted weights, then the epilogue's
    arithmetic: per 128-column tile a = tanh, g = sigmoid of the same 64 j,
    their dropout, a 64-column partial logit per tile, the partials added in
    chunk order, then bc and, where given, the mask bias [b, t] (kernel 17
    adds none). Returns (l, a_pre, b_pre)."""
    b, t, _ = y.shape
    nh, f, e = w["wa"].shape
    c = f // et.GATE_CHUNK
    wab, bab = et.permute_gates(w)
    rows, toks = prng.site_rows(b, t, row_offset, y.device)
    ma = gl.gate_masks(seed, rows, toks, nh, f, 0, gate_rate).reshape(b, t, nh, c, 64)
    mb = gl.gate_masks(seed, rows, toks, nh, f, 1, gate_rate).reshape(b, t, nh, c, 64)
    g_perm = torch.einsum("bthe,hne->bthn", y.float().reshape(b, t, nh, e), wab) + bab
    g_perm = g_perm.reshape(b, t, nh, c, 2, 64)
    a, g = torch.tanh(g_perm[..., 0, :]), torch.sigmoid(g_perm[..., 1, :])
    part = ((a * ma) * (g * mb) * w["wc"].reshape(nh, c, 64)).sum(-1)   # [b, t, nh, c]
    l = part[..., 0]
    for i in range(1, c):
        l = l + part[..., i]
    l = l + w["bc"]
    if bias is not None:
        l = l + bias[..., None]
    return l, a.reshape(b, t, nh * f), g.reshape(b, t, nh * f)


def _plain_y(x, w, seed, row_offset, pre_rate):
    rows, toks = prng.site_rows(*x.shape[:2], row_offset, x.device)
    return pa.stack_fwd_plain(x, w, seed, rows, toks, pre_rate)[2]


@pytest.mark.parametrize("rates", [(0.0, 0.0), (0.1, 0.25)])
def test_fused_mirror_matches_the_plain_forward(setup, rates):
    """l on the valid tokens, a_pre and b_pre at rtol / atol 1e-5: the same
    f32 terms summed in another order (f = 128, 2 chunks per head)."""
    _, w, x, mask = setup
    xt = to_torch(x)
    bias = et.token_mask_bias(torch.from_numpy(mask), B, T, "cpu")
    _, _, _, _, l, saved = et.encoder_train_fwd_plain(xt, bias, w, SEED, ROW_OFFSET, *rates)
    lm, am, bm = _fused_mirror(_plain_y(xt, w, SEED, ROW_OFFSET, rates[0]), bias, w, SEED,
                               ROW_OFFSET, rates[1])
    valid = torch.from_numpy(mask)
    torch.testing.assert_close(lm[valid], l[valid], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(am, saved["ap"], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(bm, saved["bp"], rtol=1e-5, atol=1e-5)
    if rates[1]:   # the masks matter: dropping them moves the logits
        ln, _, _ = _fused_mirror(_plain_y(xt, w, SEED, ROW_OFFSET, rates[0]), bias, w, SEED,
                                 ROW_OFFSET, 0.0)
        assert (ln[valid] - l[valid]).abs().max() > 1e-3


def test_fused_mirror_matches_jax_interpret_fwd_kernel(setup):
    """At rate 0 against `_fwd_call` in interpret mode (save_acts): the
    valid logits and the saved a_pre / b_pre columns at rtol 1e-4 / atol
    1e-5, as the other parity tests of the train op."""
    from madeleine_tpu.ops.encoder_train import _fwd_call, _mask_bias, _weight_args

    params, w, x, mask = setup
    emb = params["wsi_embedders"]
    wargs = _weight_args(emb["pre_attn"], emb["attn"], params["token_projector"], jnp.float32)
    seed2 = jnp.stack([jnp.int32(SEED), jnp.int32(0)])
    _, _, _, _, l_j, (sv, _) = _fwd_call(
        jnp.asarray(x), _mask_bias(jnp.asarray(mask), B, T, pad=T % T_BLOCK != 0), None, seed2,
        wargs, e=HID, nh=NH, nv=1, pre_rate=0.0, gate_rate=0.0, t_block=T_BLOCK, save_acts=True,
        interpret=True)
    l_j, sv = np.asarray(l_j)[:, :T], np.asarray(sv)[:, :T]
    xt = to_torch(x)
    bias = et.token_mask_bias(torch.from_numpy(mask), B, T, "cpu")
    lm, am, bm = _fused_mirror(_plain_y(xt, w, SEED, 0, 0.0), bias, w, SEED, 0, 0.0)
    c0 = 2 * HID + NH * HID   # u1 | u2 | u3 (hidden = e, E = nh e), then a_pre, b_pre
    np.testing.assert_allclose(lm.numpy()[mask], l_j[mask], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(am.numpy(), sv[..., c0:c0 + NH * F], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(bm.numpy(), sv[..., c0 + NH * F:c0 + 2 * NH * F], rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("rate", [0.0, 0.25])
def test_kernel17_mirror_matches_the_plain_forward(setup, rate):
    """Kernel 17's route (K6's gate epilogue, no mask bias) against
    `gated_logits_fwd_plain` on every token at rtol / atol 1e-5, at gate
    rates 0 and 0.25 (the per-op lane's (0.1, 0.25) pair: y from the plain
    stack at 0.1), with the masks' control at 0.25."""
    _, w, x, _ = setup
    pre_rate = 0.1 if rate else 0.0
    y = _plain_y(to_torch(x), w, SEED, ROW_OFFSET, pre_rate)
    lm, _, _ = _fused_mirror(y, None, w, SEED, ROW_OFFSET, rate)
    want = gl.gated_logits_fwd_plain(y, w, SEED, ROW_OFFSET, rate)
    torch.testing.assert_close(lm, want, rtol=1e-5, atol=1e-5)
    if rate:   # the masks matter: dropping them moves the logits
        ln, _, _ = _fused_mirror(y, None, w, SEED, ROW_OFFSET, 0.0)
        assert (ln - want).abs().max() > 1e-3


def _gate_setup(f):
    _, _, params, model = param_pair(seed=6, patch_embedding_dim=D, wsi_encoder_hidden_dim=HID,
                                     n_heads=NH, attention_hidden_dim=f)
    y = np.random.default_rng(9).standard_normal((B, T, NH * HID)).astype(np.float32)
    return params, {k: v.detach() for k, v in train_weights(model, torch.float32).items()}, y


@pytest.mark.parametrize("f", [128, 512])
def test_kernel17_mirror_matches_jax_interpret_fwd_kernel(f):
    """At rate 0 against the JAX package's gated-logits `_fwd_call` in
    interpret mode (madeleine_tpu/ops/gated_logits.py `_fwd_kernel`): the
    logits at rtol 1e-4 / atol 1e-5, with f = 128 (two 64-column chunks
    per head) and 512 (eight)."""
    from madeleine_tpu.ops.gated_logits import _fwd_call

    params, w, y = _gate_setup(f)
    attn = params["wsi_embedders"]["attn"]
    nh, e, _ = attn["wa"].shape
    l_j = _fwd_call(
        jnp.asarray(y), jnp.int32(SEED),
        jnp.asarray(attn["wa"], jnp.float32), jnp.asarray(attn["ba"], jnp.float32),
        jnp.asarray(attn["wb"], jnp.float32), jnp.asarray(attn["bb"], jnp.float32),
        jnp.asarray(attn["wc"], jnp.float32).reshape(nh, f),
        jnp.asarray(attn["bc"], jnp.float32).reshape(nh, 1),
        e=e, nh=nh, f=f, rate=0.0, t_block=T_BLOCK, interpret=True)
    lm, _, _ = _fused_mirror(to_torch(y), None, w, SEED, 0, 0.0)
    np.testing.assert_allclose(lm.numpy(), np.asarray(l_j), rtol=1e-4, atol=1e-5)
