"""The training softmax pool (madeleine_torch/ops/attn_pool.py: rows 4 and 5,
`fused_attention_pool`) against the JAX package on the CPU, where the port
runs the plain versions `pool_ms_plain` and `pool_bwd_plain`: row 4 against
JAX's interpret-mode `_pool_pallas_ms`, row 5 against its interpret-mode
`_pool_bwd_call`, and the autograd op's gradients against JAX's
`fused_attention_pool` through `jax.grad`; with bf16 features, the logits'
gradient summed over tokens against the pooled output's rounding term and
JAX's interpret-mode rows 4-5.

Shapes: b = 3, nh = 4, e = 16, t = 96 (three of JAX's 32-token blocks) or
t = 70 (a partial last block); f32. Tolerances: pooled rtol 1e-5 / atol
1e-5, m and s rtol 1e-5 (the same f32 sums in another order); dx and dl
rtol 1e-4 / atol 1e-5 x the largest (tests/test_pallas_pool.py's bar for
the kernel against the XLA VJP)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madeleine_tpu.ops import attn_pool as jap
from madeleine_torch.ops import attn_pool as ap
from tests.torch_port_helpers import ragged_mask

B, NH, E_HEAD, T_BLOCK = 3, 4, 16, 32
POOL_TOL = dict(rtol=1e-5, atol=1e-5)

# (t, bag lengths): full bags, ragged bags, and a t that is no multiple of the block
CASES = {"full": (96, [96, 96, 96]), "ragged": (96, [96, 50, 7]),
         "partial_block": (70, [70, 33, 64])}


def _inputs(seed, t, lengths):
    """y [b, t, E], pre-masked f32 logits [b, t, nh], mask, cotangent g [b, E]."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((B, t, NH * E_HEAD)).astype(np.float32)
    logits = (3.0 * rng.standard_normal((B, t, NH))).astype(np.float32)
    mask = ragged_mask(lengths, t)
    l32 = np.where(mask[..., None], logits, ap.NEG_INF).astype(np.float32)
    g = rng.standard_normal((B, NH * E_HEAD)).astype(np.float32)
    return y, logits, mask, l32, g


def _jax_ms(y, l32):
    out, m, s = jap._pool_pallas_ms(jnp.asarray(y), jnp.asarray(l32), e=E_HEAD, nh=NH,
                                    t_block=T_BLOCK, interpret=True)
    return tuple(np.array(v).reshape(B, -1) for v in (out, m, s))


def _close(got, want, rtol=1e-4):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("case", list(CASES))
def test_pool_ms_plain_matches_jax_interpret_kernel(case):
    """Row 4's plain version: the pooled output and the stats (m, s), and
    the stats' identity sum_t exp(l - m) / s = 1 per (bag, head)."""
    t, lengths = CASES[case]
    y, _, _, l32, _ = _inputs(0, t, lengths)
    want, wm, ws = _jax_ms(y, l32)
    got, m, s = ap.pool_ms_plain(torch.from_numpy(y), torch.from_numpy(l32))
    np.testing.assert_allclose(got.numpy(), want, **POOL_TOL)
    np.testing.assert_allclose(m.numpy(), wm, rtol=1e-6)
    np.testing.assert_allclose(s.numpy(), ws, rtol=1e-5)
    a = ap.pool_weights(torch.from_numpy(l32), m, s)
    np.testing.assert_allclose(a.sum(1).numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_pool_bwd_plain_matches_jax_interpret_kernel(case):
    """Row 5's plain version on JAX's saved stats and inner (formed from
    JAX's pooled output, as its backward does)."""
    t, lengths = CASES[case]
    y, _, _, l32, g = _inputs(1, t, lengths)
    out, m, s = _jax_ms(y, l32)
    inner = (g * out).reshape(B, NH, E_HEAD).sum(-1)
    wdx, wdl = jap._pool_bwd_call(jnp.asarray(y), jnp.asarray(l32), jnp.asarray(m[:, None]),
                                  jnp.asarray(s[:, None]), jnp.asarray(g[:, None]),
                                  jnp.asarray(inner[:, None]), e=E_HEAD, nh=NH, t_block=T_BLOCK,
                                  interpret=True)
    dx, dl = ap.pool_bwd_plain(*(torch.from_numpy(v) for v in (y, l32, m, s, g, inner)))
    assert dx.dtype == torch.float32 and dl.dtype == torch.float32
    _close(dx.numpy(), np.asarray(wdx))
    _close(dl.numpy(), np.asarray(wdl))


@pytest.mark.parametrize("case", list(CASES))
def test_fused_attention_pool_grads_match_jax(case):
    """The autograd op on CPU tensors: its output and the gradients of
    sum(w * pooled) for xh and the raw logits against JAX's
    `fused_attention_pool` (its custom VJP's XLA route) through jax.grad."""
    t, lengths = CASES[case]
    y, logits, mask, _, g = _inputs(2, t, lengths)
    xh = y.reshape(B, t, NH, E_HEAD)
    w = g.reshape(B, NH, E_HEAD)

    def loss(xh, lg):
        return jnp.sum(w * jap.fused_attention_pool(xh, lg, jnp.asarray(mask)))

    want = np.asarray(jap.fused_attention_pool(jnp.asarray(xh), jnp.asarray(logits),
                                               jnp.asarray(mask)))
    wdx, wdl = jax.grad(loss, argnums=(0, 1))(jnp.asarray(xh), jnp.asarray(logits))
    txh = torch.from_numpy(xh).requires_grad_(True)
    tl = torch.from_numpy(logits).requires_grad_(True)
    pooled = ap.fused_attention_pool(txh, tl, torch.from_numpy(mask))
    (pooled * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(pooled.detach().numpy(), want, **POOL_TOL)
    _close(txh.grad.numpy(), np.asarray(wdx))
    _close(tl.grad.numpy(), np.asarray(wdl))


def test_empty_bag_pools_to_zero_with_zero_finite_gradients():
    """A bag with no unmasked token: pooled 0, stats (NEG_INF, 1e-30), dx and
    dl exactly 0 and the other bags as in JAX (ROADMAP.md C: the TPU kernel
    pools such a bag uniformly, JAX's XLA route gives 0 as the port does)."""
    t = 70
    y, logits, mask, l32, g = _inputs(3, t, [70, 0, 21])
    got, m, s = ap.pool_ms_plain(torch.from_numpy(y), torch.from_numpy(l32))
    assert (got[1] == 0).all() and torch.equal(m[1], torch.full((NH,), ap.NEG_INF))
    assert torch.equal(s[1], torch.full((NH,), 1e-30))
    want, _, _ = _jax_ms(y, l32)
    np.testing.assert_allclose(got.numpy()[[0, 2]], want[[0, 2]], **POOL_TOL)
    xh = torch.from_numpy(y.reshape(B, t, NH, E_HEAD)).requires_grad_(True)
    tl = torch.from_numpy(logits).requires_grad_(True)
    pooled = ap.fused_attention_pool(xh, tl, torch.from_numpy(mask))
    (pooled * torch.from_numpy(g.reshape(B, NH, E_HEAD))).sum().backward()
    assert torch.isfinite(xh.grad).all() and torch.isfinite(tl.grad).all()
    assert (xh.grad[1] == 0).all() and (tl.grad[1] == 0).all()
    assert (xh.grad[2, 21:] == 0).all() and (tl.grad[2, 21:] == 0).all()


def test_train_pool_wrappers_refuse_cpu_tensors():
    """Only the op falls to the plain versions on a CPU tensor; the kernel
    wrappers raise rather than fall back."""
    y, l = torch.zeros(1, 8, 64), torch.zeros(1, 8, 4)
    with pytest.raises(ValueError, match="CUDA"):
        ap.pool_ms_cuda(y, l)
    z = torch.zeros(1, 4)
    with pytest.raises(ValueError, match="CUDA"):
        ap.pool_bwd_cuda(y, l, z, z, torch.zeros(1, 64), z)


def test_bf16_logit_gradient_sums_to_the_pooled_rounding_term():
    """With bf16 token features the backward forms inner from the bf16
    pooled output, as JAX's kernel route does (attn_pool.py:413-420), so
    sum_t dl per (bag, head) is not 0 but g . (pooled - bf16(pooled)),
    pooled the f32 pool of the same bf16 y. The port's is held to that term
    and to JAX's (its interpret-mode rows 4-5 on the same bf16 inputs, inner
    formed as its backward forms it) at 1e-5 x the largest sum_e |g pooled|
    (f32 rounding of t terms of that size)."""
    t, lengths = CASES["ragged"]
    y, logits, mask, l32, g = _inputs(4, t, lengths)
    yb = torch.from_numpy(y).to(torch.bfloat16)
    gb = torch.from_numpy(g).to(torch.bfloat16).float()
    tl = torch.from_numpy(logits).requires_grad_(True)
    pooled = ap.fused_attention_pool(yb.reshape(B, t, NH, E_HEAD), tl, torch.from_numpy(mask))
    assert pooled.dtype == torch.bfloat16
    (pooled.float() * gb.reshape(B, NH, E_HEAD)).sum().backward()
    pooled = pooled.detach().reshape(B, -1)
    p32 = ap.pool_ms_plain(yb.float(), torch.from_numpy(l32))[0]
    term = (gb * (p32 - pooled.float())).reshape(B, NH, E_HEAD).sum(-1)
    scale = float((gb.abs() * p32.abs()).reshape(B, NH, E_HEAD).sum(-1).max())
    assert term.abs().max() > 1e-4 * scale   # the term stands tenfold above the bar
    got = tl.grad.sum(1).numpy()
    np.testing.assert_allclose(got, term.numpy(), rtol=0, atol=1e-5 * scale)

    jy = jnp.asarray(y, jnp.bfloat16)
    out, m, s = jap._pool_pallas_ms(jy, jnp.asarray(l32), e=E_HEAD, nh=NH, t_block=T_BLOCK,
                                    interpret=True)
    assert np.array_equal(np.asarray(out.astype(jnp.float32)).reshape(B, -1),
                          pooled.float().numpy())
    g_flat = jnp.asarray(gb.numpy())[:, None]
    inner = jnp.sum(g_flat.reshape(B, NH, E_HEAD) * out.astype(jnp.float32).reshape(
        B, NH, E_HEAD), axis=-1).reshape(B, 1, NH)
    _, dl = jap._pool_bwd_call(jy, jnp.asarray(l32), m, s, g_flat, inner, e=E_HEAD, nh=NH,
                               t_block=T_BLOCK, interpret=True)
    np.testing.assert_allclose(got, np.asarray(dl).sum(1), rtol=0, atol=1e-5 * scale)
