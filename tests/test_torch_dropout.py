"""Standalone dropout (madeleine_torch/ops/dropout.py, row 21) on the CPU,
where the op runs its plain version `dropout_plain`: the identity at rate 0;
at the heads' rate 0.2 and the encoder's 0.1 and 0.25 the keep rate within 3
sigma, E[mask] = 1 from the integer threshold, the backward's mask equal to
the forward's, two calls equal, masks that do not depend on how the rows are
split (row_offset), and Philox streams that never meet the encoder's.

The JAX kernel draws TPU hardware bits and its CPU route jax.random's, so
the two packages' masks differ in value (ROADMAP.md C); JAX is held to the
same law here: its `dropout` at the same rate keeps within the same bar."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madeleine_tpu.ops import dropout as jdrop
from madeleine_torch.ops import dropout as dp
from madeleine_torch.ops import prng

RATES = [0.1, 0.2, 0.25]
M, N = 1024, 512


def _x(seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((M, N)).astype(np.float32)).to(dtype)


def _mask(seed, rate, m=M, row_offset=0, site=0):
    """The keep-scale mask over [m, N], read off dropout of ones."""
    return dp.dropout(torch.ones(m, N), rate, seed, row_offset=row_offset, site=site)


def test_rate_zero_is_the_identity():
    x = _x()
    assert dp.dropout(x, 0.0, 3) is x
    assert torch.equal(dp.dropout_plain(x, 3, 0.0), x)


@pytest.mark.parametrize("rate", RATES)
def test_keep_rate_and_mean_within_3_sigma(rate):
    """Over 2**19 sites: the kept share within 3 sigma of 1 - thr / 2**32,
    the mask's mean within 3 sigma of 1, its values {0, scale} with scale
    from the integer threshold; JAX's dropout at the same rate within the
    same bar of 1 - rate."""
    thr, scale = prng.threshold(rate)
    p = 1.0 - thr / 2 ** 32
    n = M * N
    sigma = np.sqrt(p * (1 - p) / n)
    m = _mask(11, rate)
    assert set(torch.unique(m).tolist()) == {0.0, np.float32(scale)}
    assert abs(float((m > 0).double().mean()) - p) <= 3 * sigma
    assert abs(float(m.double().mean()) - 1.0) <= 3 * scale * sigma
    jm = np.asarray(jdrop.dropout(jnp.ones((M, N)), rate, jax.random.PRNGKey(11)))
    assert abs(float((jm > 0).mean()) - (1 - rate)) <= 3 * sigma


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_backward_regenerates_the_forward_mask(rate, dtype):
    """y = dropout(x): dL/dx for L = sum(y * g) is mask * g with the
    forward's mask, bit for bit; two calls give the same output."""
    x = _x(1, dtype).requires_grad_(True)
    g = _x(2, dtype)
    y = dp.dropout(x, rate, 5)
    (y.float() * g.float()).sum().backward()
    mask = _mask(5, rate)
    assert torch.equal(y.detach(), (x.detach().float() * mask).to(dtype))
    assert torch.equal(x.grad, (g.float() * mask).to(dtype))
    assert torch.equal(dp.dropout(x.detach(), rate, 5), y.detach())
    assert not torch.equal(dp.dropout(x.detach(), rate, 6), y.detach())


@pytest.mark.parametrize("rate", RATES)
def test_masks_follow_the_global_row(rate):
    """Rows split into shards with their row offsets give the whole batch's
    mask; a row's mask does not depend on its neighbours."""
    whole = _mask(7, rate)
    shards = torch.cat([_mask(7, rate, m=b - a, row_offset=a)
                        for a, b in ((0, 300), (300, 301), (301, M))])
    assert torch.equal(whole, shards)
    assert not torch.equal(whole[1:], _mask(7, rate)[:-1])


@pytest.mark.parametrize("rate", RATES)
def test_streams_are_disjoint_from_the_encoders(rate):
    """The encoder's train ops (encoder_train_fwd_plain, kernels 15-18) draw
    streams 0 to 2 + 2*nh (nh <= 32); dropout sites draw from 2**31 up. At
    the same seed, rows and columns (token 0), a dropout site's mask is
    none of the encoder's and agrees with each about as two independent
    masks do (p^2 + (1 - p)^2); two sites differ too."""
    assert prng.dropout_stream(0) > prng.gate_stream(31, 1)
    seed = 13
    rows = torch.arange(M)
    drop = _mask(seed, rate) > 0
    p = 1.0 - prng.threshold(rate)[0] / 2 ** 32
    expect = p * p + (1 - p) * (1 - p)
    others = [prng.keep_mask(seed, rows, torch.zeros_like(rows), k, N, rate) > 0
              for k in range(3 + 2 * 32)] + [_mask(seed, rate, site=1) > 0]
    for other in others:
        assert abs(float((drop == other).float().mean()) - expect) < 0.01
