"""Kernel K2 (ops/gated_pool.py): the port's plain version against the JAX
Pallas kernel in interpret mode, in f32. Tolerance rtol 1e-4 / atol 1e-5:
XLA and ATen sum the gate products in different orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madeleine_tpu.ops.gated_pool import gated_attention_pool as jax_gated_attention_pool
from madeleine_torch.models.abmil import gate_weights
from madeleine_torch.ops import gated_pool as gp
from madeleine_torch.ops.attn_pool import mask_bias
from tests.torch_port_helpers import configs, jax_params, port_model, ragged_mask, to_torch


def _setup(seed, b, t, nh, hidden, f):
    jcfg, cfg = configs(wsi_encoder_hidden_dim=hidden, n_heads=nh, attention_hidden_dim=f)
    params = jax_params(jcfg, seed)
    model = port_model(cfg, params)
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((b, t, nh, hidden)).astype(np.float32)
    return params, model, xh


@pytest.mark.parametrize("case", [
    dict(seed=0, b=3, t=200, nh=2, hidden=128, f=64, lengths=[200, 121, 7]),   # ragged
    dict(seed=1, b=2, t=200, nh=2, hidden=128, f=64, lengths=None),            # no mask
    dict(seed=2, b=2, t=37, nh=1, hidden=64, f=64, lengths=[37, 19]),          # one head
])
def test_plain_matches_jax_interpret(case):
    params, model, xh = _setup(case["seed"], case["b"], case["t"], case["nh"],
                               case["hidden"], case["f"])
    mask = None if case["lengths"] is None else ragged_mask(case["lengths"], case["t"])
    want = jax_gated_attention_pool(
        jax.tree_util.tree_map(jnp.asarray, params["wsi_embedders"]["attn"]),
        jnp.asarray(xh), None if mask is None else jnp.asarray(mask),
        t_block=64, interpret=True)
    got = gp.gated_attention_pool(gate_weights(model.wsi_embedders), to_torch(xh),
                                  None if mask is None else torch.from_numpy(mask))
    assert got.shape == (case["b"], case["nh"], case["hidden"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_cpu_tensor_takes_plain_version_and_counts_nothing():
    _, model, xh = _setup(3, 2, 50, 2, 128, 64)
    before = gp.launches
    gp.gated_attention_pool(gate_weights(model.wsi_embedders), to_torch(xh))
    assert gp.launches == before


def test_kernel_entry_rejects_cpu_tensors():
    _, model, xh = _setup(4, 2, 50, 2, 128, 64)
    w = {k: v.detach().contiguous() for k, v in gate_weights(model.wsi_embedders).items()}
    y = to_torch(xh).reshape(2, 50, 256)
    with pytest.raises(ValueError, match="CUDA"):
        gp.gated_pool_cuda(y, mask_bias(None, 2, 50, 2, torch.device("cpu")), **w)
