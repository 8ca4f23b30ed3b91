"""Kernel 18's gate adjoint in its recomputed gate product's epilogue
(madeleine_torch/csrc/gemm_wgmma.cuh::epilogue_gates_bwd, launched by
csrc/gated_logits.cu::gated_logits_backward), mirrored on the CPU: the
product on K6's permuted [Wa; Wb] (`gated_logits.permute_gates`), the
adjoint formed per 128-column tile, DZG in the natural per-head
[dza | dzb] order, the per-64-row-tile column partials of dwc, dba and dbb
in the kernel's order (a thread's two rows, the warp's xor butterfly, the
four warps in order) and their sum in colsum_reduce's order; then the two
products of DZG. Held against the plain backward and against the JAX
package's interpret-mode `_bwd_call`. f32 throughout; the kernel itself is
held against the plain backward and its first design on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madeleine_torch.models.madeleine import train_weights
from madeleine_torch.ops import gated_logits as gl
from madeleine_torch.ops import preattn as pa
from madeleine_torch.ops import prng
from tests.torch_port_helpers import param_pair, to_torch

B, T, NH, E, F = 2, 40, 2, 64, 128   # M = 80: a partial last 64-row tile; f = 128: two chunks
T_BLOCK = 32
SEED, ROW_OFFSET = 17, 5
ROW_TILE = 64   # rows per column partial (csrc/train_common.cuh)


@pytest.fixture(scope="module")
def setup():
    _, _, params, model = param_pair(seed=5, wsi_encoder_hidden_dim=E, n_heads=NH,
                                     attention_hidden_dim=F)
    rng = np.random.default_rng(8)
    y = rng.standard_normal((B, T, NH * E)).astype(np.float32)
    dl = rng.standard_normal((B, T, NH)).astype(np.float32)
    w = {k: v.detach() for k, v in train_weights(model, torch.float32).items()}
    return params, w, y, dl


def _tile_sums(v):
    """Column sums of v [M, C] per 64-row tile in the epilogue's order:
    thread i of a warp adds its rows i and i + 8, the warp's xor butterfly
    over lanes 4, 8, 16 (i's bits 0, 1, 2), then the four warps in order.
    Rows past M count as 0 (the kernel's dl is 0 there). Returns [tiles, C]."""
    m, c = v.shape
    tiles = -(-m // ROW_TILE)
    v = torch.cat([v, v.new_zeros(tiles * ROW_TILE - m, c)]).reshape(tiles, 4, 2, 8, c)
    s = v[:, :, 0] + v[:, :, 1]                 # [tiles, warp, i, c]
    s = s[:, :, 0::2] + s[:, :, 1::2]           # xor 4
    s = s[:, :, 0::2] + s[:, :, 1::2]           # xor 8
    s = s[:, :, 0] + s[:, :, 1]                 # xor 16: [tiles, warp, c]
    return ((s[:, 0] + s[:, 1]) + s[:, 2]) + s[:, 3]


def _colsum_reduce(part):
    """csrc/train_common.cuh::colsum_reduce_kernel's order over [tiles, C]:
    row y of the block sums tiles y, y + 8, ... in turn, then the 8 rows in order."""
    rows = []
    for y in range(8):
        s = part.new_zeros(part.shape[1])
        for i in range(y, part.shape[0], 8):
            s = s + part[i]
        rows.append(s)
    out = part.new_zeros(part.shape[1])
    for s in rows:
        out = out + s
    return out


def _epilogue_mirror(y, dl, w, seed, row_offset, rate, drop_last_tile=False):
    """Kernel 18's arithmetic in its order. Returns {"y": dy, "wa", "ba", "wb",
    "bb", "wc", "bc"} as `gated_logits_bwd_plain`; drop_last_tile leaves the
    last 64-row tile's column partials out (a control)."""
    b, t, _ = y.shape
    nh, f, e = w["wa"].shape
    c, M = f // gl.GATE_CHUNK, b * t
    wabp, babp = gl.permute_gates(w)
    rows, toks = prng.site_rows(b, t, row_offset, y.device)
    ma = gl.gate_masks(seed, rows, toks, nh, f, 0, rate).reshape(M, nh, c, 64)
    mb = gl.gate_masks(seed, rows, toks, nh, f, 1, rate).reshape(M, nh, c, 64)
    yh = y.reshape(M, nh, e)
    # the product on the permuted rows: tile c holds a's 64 j, then g's
    z = (torch.einsum("mhe,hne->mhn", yh, wabp) + babp).reshape(M, nh, c, 2, 64)
    a, g = torch.tanh(z[..., 0, :]), torch.sigmoid(z[..., 1, :])
    dlh = dl.reshape(M, nh)[..., None, None]
    wc = w["wc"].reshape(nh, c, 64)
    ad, gd = a * ma, g * mb
    dg = dlh * wc
    dza = dg * gd * ma * (1.0 - a * a)
    dzb = dg * ad * mb * g * (1.0 - g)
    dwc = (ad * gd) * dlh
    # DZG in the natural per-head [dza | dzb] order, rounded to the compute dtype
    dzg = torch.stack([dza.reshape(M, nh, f), dzb.reshape(M, nh, f)], dim=2)   # [M, nh, 2, f]
    dzg = pa.wide(dzg.to(y.dtype))
    # column partials in gate_bwd's layout: [dwc (nh f) | per head dba (f), dbb (f)]
    cols = torch.cat([dwc.reshape(M, nh * f),
                      torch.stack([dza.reshape(M, nh, f), dzb.reshape(M, nh, f)],
                                  dim=2).reshape(M, 2 * nh * f)], dim=1)
    part = _tile_sums(cols)
    if drop_last_tile:
        part = part[:-1]
    sums = _colsum_reduce(part)
    dbab = sums[nh * f:].reshape(nh, 2, f)
    wab = torch.cat([w["wa"], w["wb"]], dim=1)                                # [nh, 2f, e]
    dy = torch.einsum("mhn,hne->mhe", dzg.reshape(M, nh, 2 * f), pa.wide(wab))
    dwab = torch.einsum("mhn,mhe->hne", dzg.reshape(M, nh, 2 * f), pa.wide(yh))
    return {"y": dy.reshape(b, t, nh * e).to(y.dtype), "wa": dwab[:, :f], "wb": dwab[:, f:],
            "ba": dbab[:, 0], "bb": dbab[:, 1], "wc": sums[:nh * f].reshape(nh, f),
            "bc": dl.sum((0, 1))}


@pytest.mark.parametrize("rates", [0.0, 0.25], ids=["rate0", "rate0.25"])
def test_mirror_matches_the_plain_backward(setup, rates):
    """Every output at rtol / atol 1e-5 at a ragged M (80 rows: the second
    64-row tile holds 16): the same f32 terms summed in another order."""
    _, w, y, dl = setup
    yt, dlt = to_torch(y), to_torch(dl)
    got = _epilogue_mirror(yt, dlt, w, SEED, ROW_OFFSET, rates)
    want = gl.gated_logits_bwd_plain(yt, dlt, w, SEED, ROW_OFFSET, rates)
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-5, msg=k)
    if rates:   # the masks matter: the mirror without them misses
        off = _epilogue_mirror(yt, dlt, w, SEED, ROW_OFFSET, 0.0)
        assert (off["ba"] - want["ba"]).abs().max() > 1e-3


def test_dropped_tile_control_misses(setup):
    """The partial last tile's column partials count: without them dba, dbb
    and dwc miss the plain backward by far more than 1e-5."""
    _, w, y, dl = setup
    yt, dlt = to_torch(y), to_torch(dl)
    got = _epilogue_mirror(yt, dlt, w, SEED, ROW_OFFSET, 0.25, drop_last_tile=True)
    want = gl.gated_logits_bwd_plain(yt, dlt, w, SEED, ROW_OFFSET, 0.25)
    for k in ("ba", "bb", "wc"):
        assert (got[k] - want[k]).abs().max() > 1e-3, k


def test_mirror_matches_jax_interpret_bwd_call(setup):
    """At rate 0 against `_bwd_call` in interpret mode: dy and the five
    gradients at rtol 1e-4, atol 1e-5 x the largest entry."""
    from madeleine_tpu.ops.gated_logits import _bwd_call

    params, w, y, dl = setup
    attn = params["wsi_embedders"]["attn"]
    nh, e, f = attn["wa"].shape
    dy_j, dwa, dba, dwb, dbb, dwc = _bwd_call(
        jnp.asarray(y), jnp.asarray(dl), jnp.int32(SEED),
        jnp.asarray(attn["wa"], jnp.float32), jnp.asarray(attn["ba"], jnp.float32),
        jnp.asarray(attn["wb"], jnp.float32), jnp.asarray(attn["bb"], jnp.float32),
        jnp.asarray(attn["wc"], jnp.float32).reshape(nh, f),
        jnp.asarray(attn["bc"], jnp.float32).reshape(nh, 1),
        e=e, nh=nh, f=f, rate=0.0, t_block=T_BLOCK, interpret=True)
    got = _epilogue_mirror(to_torch(y), to_torch(dl), w, SEED, 0, 0.0)
    want = {"y": dy_j, "wa": np.swapaxes(np.asarray(dwa), 1, 2), "ba": dba,
            "wb": np.swapaxes(np.asarray(dwb), 1, 2), "bb": dbb, "wc": dwc}
    for k, ref in want.items():
        ref = np.asarray(ref)
        np.testing.assert_allclose(got[k].numpy(), ref, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(ref).max()), err_msg=k)


@pytest.mark.parametrize("name", ["preattn_bwd_cuda", "preattn_bwd_rowblock_cuda",
                                  "gated_logits_bwd_cuda", "gated_logits_bwd_rowblock_cuda",
                                  "preattn_fwd_cuda", "preattn_fwd_rowblock_cuda",
                                  "gated_logits_fwd_cuda", "gated_logits_fwd_rowblock_cuda"])
def test_backward_wrappers_refuse_cpu_tensors_and_count_nothing(setup, name):
    """Kernels 16 and 18, the forwards 15 and 17, and the first designs of
    all four take CUDA tensors only: a CPU call raises before any launch and
    moves no counter."""
    from madeleine_torch.ops import launches

    _, w, y, dl = setup
    mod = pa if name.startswith("preattn") else gl
    before = launches.read()
    if mod is pa:
        x = torch.zeros(1, 8, 32, dtype=torch.bfloat16)
        args = (x, torch.zeros(1, 8, 64, dtype=torch.bfloat16), w, 1)
    else:
        args = (to_torch(y, torch.bfloat16), to_torch(dl), w, 1)
    if "_fwd" in name:   # a forward takes no cotangent
        args = args[:1] + args[2:]
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        getattr(mod, name)(*args)
    assert launches.read() == before
