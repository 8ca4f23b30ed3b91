"""Kernel K3's op (madeleine_torch/ops/attn_pool.py) against the JAX
package's streaming pool: its interpret-mode twin of `_pool_kernel`
(`masked_attention_pool(..., interpret=True)`, `_pool_pallas_interpret`) and
its plain `_pool_reference`, on the CPU, where the port runs K3's plain
version `softmax_pool_plain`.

Shapes: b = 3, t = 700 (one full 512-token block of the TPU kernel and a
partial one), nh = 4,
e = 16. Tolerances: f32 rtol 1e-5 / atol 1e-6 (the same f32 sums in another
order); bf16 inputs atol 2e-2 on the bf16 output (one bf16 rounding of
values of order 1)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madeleine_tpu.ops import attn_pool as jap
from madeleine_torch.ops import attn_pool as ap
from tests.torch_port_helpers import ragged_mask

B, T, NH, E_HEAD = 3, 700, 4, 16
F32_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_ATOL = 2e-2


def _inputs(seed, lengths, logit_scale=3.0):
    """xh [b, t, nh, e] f32, raw logits [b, t, nh] f32 (spread by several
    units, so the pool is far from uniform), mask [b, t] bool."""
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((B, T, NH, E_HEAD)).astype(np.float32)
    logits = (logit_scale * rng.standard_normal((B, T, NH))).astype(np.float32)
    return xh, logits, ragged_mask(lengths, T)


def _masked_logits(logits, mask):
    return np.where(mask[..., None], logits, ap.NEG_INF).astype(np.float32)


def _port_plain(xh, logits, mask, dtype):
    """K3's plain version on its kernel's operands: y in the compute dtype,
    pre-masked f32 logits -> [b, nh*e] in y's dtype."""
    yh = torch.from_numpy(xh).to(dtype)
    l32 = torch.from_numpy(_masked_logits(logits, mask))
    return ap.softmax_pool_plain(l32, yh).to(dtype)


def _jax_dtype(dtype):
    return jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("lengths,logit_scale",
                         [([700, 700, 700], 3.0), ([700, 513, 37], 3.0), ([700, 512, 1], 3.0),
                          ([700, 611, 90], 40.0)],
                         ids=["full", "ragged", "block_edge", "peaked"])
def test_plain_pool_matches_jax_interpret_kernel(dtype, lengths, logit_scale):
    """K3's plain version against the JAX package's own interpret-mode run
    of `_pool_kernel` (512-token blocks, NEG_INF padding). Peaked logits
    (scale 40) put each head's weight on a few tokens, so a pool that
    weighed tokens wrongly, or a TPU block carry the plain version
    disagreed with, would show."""
    xh, logits, mask = _inputs(0, lengths, logit_scale)
    jdt = _jax_dtype(dtype)
    want = jap.masked_attention_pool(jnp.asarray(xh, jdt), jnp.asarray(logits),
                                     jnp.asarray(mask), interpret=True)
    got = _port_plain(xh, logits, mask, dtype)
    assert got.dtype == dtype and got.shape == (B, NH * E_HEAD)
    want = np.asarray(want, np.float32).reshape(B, NH * E_HEAD)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=BF16_ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_empty_bag_pools_to_zero_and_leaves_the_others(dtype):
    """One bag with no unmasked token pools to 0 (ROADMAP.md C), as in
    JAX's `_pool_reference`; the interpret-mode TPU kernel pools it
    uniformly, and the other bags match that kernel."""
    xh, logits, mask = _inputs(1, [700, 0, 230])
    jdt = _jax_dtype(dtype)
    got = _port_plain(xh, logits, mask, dtype).float().numpy()
    assert (got[1] == 0).all()
    kern = np.asarray(jap.masked_attention_pool(jnp.asarray(xh, jdt), jnp.asarray(logits),
                                                jnp.asarray(mask), interpret=True),
                      np.float32).reshape(B, -1)
    ref = np.asarray(jap._pool_reference(jnp.asarray(xh, jdt), jnp.asarray(logits),
                                         jnp.asarray(mask), "softmax"),
                     np.float32).reshape(B, -1)
    assert (ref[1] == 0).all()
    tol = F32_TOL if dtype == torch.float32 else dict(rtol=0, atol=BF16_ATOL)
    np.testing.assert_allclose(got[[0, 2]], kern[[0, 2]], **tol)
    np.testing.assert_allclose(got, ref, **tol)


@pytest.mark.parametrize("activation", ["softmax", "relu", "leaky_relu", "sigmoid"])
def test_masked_attention_pool_matches_jax_reference(activation):
    """`masked_attention_pool` on CPU tensors (the plain route, any
    activation) against JAX's `_pool_reference`, and for softmax also K3's
    op (`softmax_pool`, which runs its plain version on the CPU). The
    elementwise activations pool unnormalised sums of up to 700 terms of
    order 100, so their absolute bar is 1e-5 of the largest output."""
    xh, logits, mask = _inputs(2, [700, 300, 0])
    want = np.asarray(jap._pool_reference(jnp.asarray(xh), jnp.asarray(logits),
                                          jnp.asarray(mask), activation))
    got = ap.masked_attention_pool(torch.from_numpy(xh), torch.from_numpy(logits),
                                   torch.from_numpy(mask), activation)
    tol = F32_TOL if activation == "softmax" else dict(rtol=1e-5,
                                                       atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, **tol)
    if activation == "softmax":
        got = ap.softmax_pool(torch.from_numpy(xh), torch.from_numpy(logits),
                              torch.from_numpy(mask))
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_kernel_wrapper_refuses_cpu_tensors():
    """On a CPU tensor only the op falls to the plain version; the kernel
    wrapper itself raises rather than fall back."""
    y = torch.zeros(1, 8, 64)
    with pytest.raises(ValueError, match="CUDA"):
        ap.attn_pool_cuda(y, torch.zeros(1, 8, 4))
