"""Kernel 15's LayerNorm / GELU / dropout rows (madeleine_torch/csrc/
preattn.cu::ln_gelu_rows_train, which kernel 16's recompute shares),
mirrored on the CPU in their reduction order: lane l of a row's warp holds
the 16-byte column groups v 32 + l, sums each group's four values as
(z0 + z1) + (z2 + z3) and the groups in v order, the warp adds the lanes
by an xor butterfly (offsets 16, 8, 4, 2, 1), then the same for the
squared deviations from the mean. The mirror of the three layers is held
against `stack_fwd_plain` (each layer's u, rstd and output) at widths 128,
512 and 2048, and against the JAX package's interpret-mode preattn
`_fwd_kernel`. f32 throughout; the kernel itself is held against the plain
forward and its first design on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madeleine_torch.ops import preattn as pa
from madeleine_torch.ops import prng

B, T, D_IN = 2, 40, 64   # t = 40: JAX's last 32-token block is partial
T_BLOCK = 32
SEED, ROW_OFFSET = 21, 2
GROUP = 4    # columns per 16-byte group of f32
LANES = 32


def _warp_sum(v):
    """madeleine::warp_sum over the last axis (32 lanes): v += shfl_xor(v, o)
    for o = 16, 8, 4, 2, 1; every lane ends with the same value."""
    lane = torch.arange(LANES)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lane ^ o]
    return v[..., 0]


def _rows_mirror(z, s, sh, keep):
    """One layer of ln_gelu_rows_train on z [M, W] f32 (bias included):
    returns (u, rstd [M], h) in f32."""
    m, width = z.shape
    zz = z.reshape(m, width // (LANES * GROUP), LANES, GROUP)   # [M, V, lane, j]
    part = torch.zeros(m, LANES)
    for v in range(zz.shape[1]):
        g = zz[:, v]
        part = part + ((g[..., 0] + g[..., 1]) + (g[..., 2] + g[..., 3]))
    mean = _warp_sum(part) / width
    d = zz - mean[:, None, None, None]
    dev = torch.zeros(m, LANES)
    for v in range(zz.shape[1]):
        for j in range(GROUP):
            dev = dev + d[:, v, :, j] * d[:, v, :, j]
    rstd = torch.rsqrt(_warp_sum(dev) / width + pa.LN_EPS)
    u = (z - mean[:, None]) * rstd[:, None]
    x = u * s + sh
    return u, rstd, x * pa.cdf(x) * keep


def _stack_mirror(x, w, seed, row_offset, rate):
    """The three layers as kernel 15 runs them, in f32: (h1, h2, y32, us,
    rstd [b, t, 3]), the layout of `stack_fwd_plain`."""
    b, t, _ = x.shape
    rows, toks = prng.site_rows(b, t, row_offset, x.device)
    h, hs, us, rstds = x.reshape(b * t, -1), [], [], []
    for i in (1, 2, 3):
        z = pa.mm(h, w[f"w{i}"]) + w[f"b{i}"]
        keep = prng.keep_mask(seed, rows, toks, i - 1, z.shape[-1], rate).reshape(b * t, -1)
        u, rstd, h = _rows_mirror(z, w[f"s{i}"], w[f"t{i}"], keep)
        us.append(u.reshape(b, t, -1))
        rstds.append(rstd.reshape(b, t, 1))
        hs.append(h.reshape(b, t, -1))
    return hs[0], hs[1], hs[2], us, torch.cat(rstds, dim=-1)


def _weights(width, rng):
    """Random operands of a stack d_in -> width -> width -> width (f32
    numpy, [out, in] layout) with LN scales near 1."""
    w = {}
    for i, fan_in in ((1, D_IN), (2, width), (3, width)):
        w[f"w{i}"] = (rng.standard_normal((width, fan_in)) / np.sqrt(fan_in)).astype(np.float32)
        w[f"b{i}"] = (0.1 * rng.standard_normal(width)).astype(np.float32)
        w[f"s{i}"] = (1.0 + 0.1 * rng.standard_normal(width)).astype(np.float32)
        w[f"t{i}"] = (0.1 * rng.standard_normal(width)).astype(np.float32)
    return w


def _setup(width):
    rng = np.random.default_rng(width)
    x = rng.standard_normal((B, T, D_IN)).astype(np.float32)
    return x, _weights(width, rng)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("width", [128, 512, 2048])
def test_rows_mirror_matches_the_plain_stack(width, rate):
    """Each layer's u, rstd and output and y against `stack_fwd_plain` at
    rtol / atol 1e-5: the same f32 terms, the statistics summed in the
    warp's order (one 16-byte group per lane at width 128, 16 at 2048)."""
    x, wn = _setup(width)
    xt, w = torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in wn.items()}
    rows, toks = prng.site_rows(B, T, ROW_OFFSET, xt.device)
    want = pa.stack_fwd_plain(xt, w, SEED, rows, toks, rate)
    got = _stack_mirror(xt, w, SEED, ROW_OFFSET, rate)
    for name, g, r in (("h1", got[0], want[0]), ("h2", got[1], want[1]),
                       ("y32", got[2], want[2]), ("rstd", got[4], want[4])):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5, msg=name)
    for i in range(3):
        torch.testing.assert_close(got[3][i], want[3][i], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[2], pa.preattn_fwd_plain(xt, w, SEED, ROW_OFFSET, rate),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("width", [128, 512, 2048])
def test_rows_mirror_matches_jax_interpret_fwd_kernel(width):
    """The mirror's three layers at rate 0 against the JAX package's
    `_fwd_call` in interpret mode (madeleine_tpu/ops/preattn.py
    `_fwd_kernel`, weights in its [in, out] layout): y at rtol 1e-4 / atol
    1e-5."""
    from madeleine_tpu.ops.preattn import _fwd_call

    x, wn = _setup(width)
    wargs = []
    for i in (1, 2, 3):
        wargs += [jnp.asarray(wn[f"w{i}"].T), jnp.asarray(wn[f"b{i}"]),
                  jnp.asarray(wn[f"s{i}"]), jnp.asarray(wn[f"t{i}"])]
    y_j = _fwd_call(jnp.asarray(x), jnp.int32(SEED), *wargs, rate=0.0, t_block=T_BLOCK,
                    interpret=True)
    w = {k: torch.from_numpy(v) for k, v in wn.items()}
    y = _stack_mirror(torch.from_numpy(x), w, SEED, 0, 0.0)[2]
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=1e-4, atol=1e-5)
