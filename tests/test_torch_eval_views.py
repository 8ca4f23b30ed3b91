"""The eval forward's half-bag views (n_views=3, train=False;
madeleine_torch/models/madeleine.py::forward_train, models/abmil.py::
abmil_embed with half_mask): on the CPU route (K3's plain version for the
views' pools) against the JAX package's eval forward, handed JAX's split,
at f32 rtol 1e-4 / atol 1e-5; the whole-bag view is the n_views=1 pool; a
seed gives the same split every time; an empty view pools to 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madeleine_tpu.models import madeleine as jm
from madeleine_torch.models.abmil import abmil_embed
from madeleine_torch.models.madeleine import forward_train, half_split
from tests.torch_port_helpers import configs, param_pair, port_model, ragged_mask, to_torch

TOL = dict(rtol=1e-4, atol=1e-5)
BS, T = 3, 40


def _jax_split(key, t):
    perm = jax.random.permutation(key, t)
    ranks = jnp.zeros((t,), jnp.int32).at[perm].set(jnp.arange(t, dtype=jnp.int32))
    return np.array(ranks < t // 2)


CASES = {
    "softmax": dict(),
    "ragged": dict(),
    "sigmoid": dict(activation="sigmoid"),
    "stain_encoding": dict(add_stain_encoding=True),
}


@pytest.fixture(scope="module")
def base():
    return param_pair(seed=4)


def _pair(base, case):
    """(JAX config, port config, params, port model): the base pair's
    parameters where the case adds none (the activation is not a weight)."""
    fields = CASES[case]
    if fields.get("add_stain_encoding"):
        return param_pair(seed=4, **fields)
    jcfg, pcfg = configs(**fields)
    return jcfg, pcfg, base[2], port_model(pcfg, base[2])


@pytest.mark.parametrize("case", sorted(CASES))
def test_eval_views_equal_jax(base, case):
    jcfg, pcfg, params, model = _pair(base, case)
    rng = np.random.default_rng(5)
    feats = rng.standard_normal(
        (BS, pcfg.n_modalities, T, pcfg.patch_embedding_dim)).astype(np.float32)
    mask = None
    if case == "ragged":
        lengths = rng.integers(5, T + 1, BS * pcfg.n_modalities)
        mask = ragged_mask(lengths, T).reshape(BS, pcfg.n_modalities, T)
    key = jax.random.PRNGKey(11)
    js, jt = jax.jit(lambda p, f, m: jm.forward_train(p, jcfg, f, mask=m, n_views=3, rng=key,
                                                      train=False))(
        params, jnp.asarray(feats), None if mask is None else jnp.asarray(mask))
    half = torch.from_numpy(_jax_split(key, T))
    ps, pt = forward_train(model, to_torch(feats), n_views=3, train=False, half_mask=half,
                           mask=None if mask is None else torch.from_numpy(mask))
    assert tuple(ps.shape) == (BS, pcfg.n_modalities, 3, pcfg.embed_dim)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), **TOL)
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), **TOL)
    # the whole-bag view is the n_views=1 eval forward's output
    one, tok1 = forward_train(model, to_torch(feats), train=False,
                              mask=None if mask is None else torch.from_numpy(mask))
    torch.testing.assert_close(ps[:, :, :1], one, rtol=0, atol=0)
    torch.testing.assert_close(pt, tok1, rtol=0, atol=0)


def test_eval_views_default_split_is_seeded(base):
    """No half_mask: half_split(seed, t), seed 0 by default (JAX's eval draws
    from PRNGKey(0)); the same seed gives the same views, another seed
    another split."""
    _, pcfg, _, model = base
    feats = to_torch(np.random.default_rng(6).standard_normal(
        (BS, pcfg.n_modalities, T, pcfg.patch_embedding_dim)).astype(np.float32))
    a, _ = forward_train(model, feats, n_views=3, train=False)
    b, _ = forward_train(model, feats, n_views=3, train=False)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    c, _ = forward_train(model, feats, n_views=3, train=False,
                         half_mask=half_split(0, T, feats.device))
    torch.testing.assert_close(a, c, rtol=0, atol=0)
    d, _ = forward_train(model, feats, n_views=3, train=False, seed=1)
    assert not torch.equal(a[:, :, 1:], d[:, :, 1:])
    torch.testing.assert_close(a[:, :, 0], d[:, :, 0], rtol=0, atol=0)
    assert int(half_split(0, T, "cpu").sum()) == T // 2


def test_an_empty_view_pools_to_zero(base):
    """A view whose half meets no valid token pools to 0 (the port's rule
    for an empty bag; JAX's plain pool gives NaN there), the other views
    stay JAX's."""
    jcfg, pcfg, params, model = base
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, T, pcfg.patch_embedding_dim)).astype(np.float32)
    half = np.zeros(T, bool)
    half[:T // 2] = True
    mask = np.zeros((2, T), bool)
    mask[0, :] = True
    mask[1, :T // 2] = True            # bag 1: every valid token in the first half
    with torch.no_grad():
        pooled = abmil_embed(model.wsi_embedders, to_torch(x), mask=torch.from_numpy(mask),
                             half_mask=torch.from_numpy(half))
    assert tuple(pooled.shape) == (2, 3, pcfg.n_heads, pcfg.wsi_encoder_hidden_dim)
    assert torch.count_nonzero(pooled[1, 2]) == 0
    assert torch.isfinite(pooled).all() and torch.count_nonzero(pooled[0, 2]) > 0
    from madeleine_tpu.models.abmil import abmil_embed as jax_embed

    key = jax.random.PRNGKey(3)
    want = jax.jit(lambda p, v, m: jax_embed(p, v, n_heads=pcfg.n_heads, mask=m, n_views=3,
                                             view_rng=key))(
        params["wsi_embedders"], jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        got = abmil_embed(model.wsi_embedders, to_torch(x), mask=torch.from_numpy(mask),
                          half_mask=torch.from_numpy(_jax_split(key, T)))
    # JAX's head-major pooled against the port's: every live view
    live = np.isfinite(np.asarray(want)).all(axis=(-1, -2))
    assert live.sum() >= 5
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live], **TOL)
