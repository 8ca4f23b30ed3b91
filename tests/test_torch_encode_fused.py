"""Kernel K1 (ops/encode_fused.py): the port's plain version against the JAX
Pallas kernel run in interpret mode, at small widths with a partial last tile.

Tolerances: f32 rtol 2e-4 / atol 2e-5 (the JAX kernel's A&S erf differs from
erf by <= 1.5e-7; the bar of tests/test_encode_fused.py). bf16 atol 3e-2 on
the bf16 output: the JAX kernel's tanh-form erf differs by <= 3.5e-6, far
below bf16 rounding, and the two sides round at the same cast points.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madeleine_tpu.ops.encode_fused import encode_pool_fused as jax_encode_pool_fused
from madeleine_torch.models.abmil import abmil_embed, encoder_weights, pre_attn_mlp
from madeleine_torch.ops import encode_fused as ef
from madeleine_torch.ops.attn_pool import mask_bias
from madeleine_torch.ops.gated_pool import gated_attention_pool
from tests.torch_port_helpers import configs, jax_params, port_model, ragged_mask, to_torch

B, T, T_BLOCK = 3, 200, 64   # 200 = 3 tiles of 64 + a partial tile of 8


def _setup(seed):
    jcfg, cfg = configs()
    params = jax_params(jcfg, seed)
    model = port_model(cfg, params)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, cfg.patch_embedding_dim)).astype(np.float32)
    return params, model, x


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_interpret(masked, dtype):
    params, model, x = _setup(seed=1 if masked else 2)
    mask = ragged_mask([200, 133, 70], T) if masked else None
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    want = jax_encode_pool_fused(
        jax.tree_util.tree_map(jnp.asarray, params["wsi_embedders"]),
        jnp.asarray(x, jdt), None if mask is None else jnp.asarray(mask),
        t_block=T_BLOCK, interpret=True)
    got = ef.encode_pool_fused(encoder_weights(model.wsi_embedders), to_torch(x, tdt),
                               None if mask is None else torch.from_numpy(mask))
    assert got.dtype == tdt and got.shape == (B, 2, 128)
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=3e-2)


def test_plain_matches_composable_route():
    """In f32, the plain versions of both kernel routes (K1 alone; the MLP then
    K2) equal the composable ABMIL path, which a CPU tensor takes."""
    _, model, x = _setup(seed=3)
    emb = model.wsi_embedders
    mask = torch.from_numpy(ragged_mask([150, 200, 9], T))
    plain = abmil_embed(emb, to_torch(x), mask=mask)
    w = encoder_weights(emb)
    k1 = ef.encode_pool_fused(w, to_torch(x), mask)
    torch.testing.assert_close(k1, plain, rtol=1e-4, atol=1e-5)
    y = pre_attn_mlp(w, to_torch(x)).reshape(B, T, emb.n_heads, emb.hidden_dim)
    k2 = gated_attention_pool(w, y, mask)
    torch.testing.assert_close(k2, plain, rtol=1e-4, atol=1e-5)


def test_bag_without_tokens_pools_to_zero():
    """As in the kernel, which skips tiles with no unmasked token; the
    composable route gives 0 there too."""
    _, model, x = _setup(seed=4)
    mask = torch.from_numpy(ragged_mask([200, 0, 31], T))
    out = ef.encode_pool_fused(encoder_weights(model.wsi_embedders),
                               to_torch(x, torch.bfloat16), mask)
    assert torch.isfinite(out.float()).all()
    assert (out[1] == 0).all() and (out[0] != 0).any()
    plain = abmil_embed(model.wsi_embedders, to_torch(x), mask=mask)
    assert (plain[1] == 0).all()


def test_cpu_tensor_takes_plain_version_and_counts_nothing():
    _, model, x = _setup(seed=5)
    before = ef.launches
    ef.encode_pool_fused(encoder_weights(model.wsi_embedders), to_torch(x, torch.bfloat16))
    assert ef.launches == before


def test_kernel_entry_rejects_cpu_tensors():
    _, model, x = _setup(seed=6)
    w = ef.kernel_weights(encoder_weights(model.wsi_embedders), torch.bfloat16)
    bias = mask_bias(None, B, T, 2, torch.device("cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        ef.encode_fused_cuda(to_torch(x, torch.bfloat16), bias, w)
