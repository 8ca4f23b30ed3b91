"""Kernel K2's split-TF32 design (csrc/gated_pool.cu, ops/gated_pool.py) on the CPU.

The card's kernel computes each f32 gate product as three TF32 products of a
hi/lo split of its operands, walks the gate width in chunks of 64 columns
whose logit partials it adds in chunk order, and merges 128-token softmax
partials in tile order. `k2_mirror` does the same arithmetic in PyTorch: it is
held against the plain version and against the JAX package's Pallas kernel
in interpret mode, on inputs made from a seed with numpy. The TF32 rounding
helper and the operand cache are tested on their own.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madeleine_tpu.ops.gated_pool import gated_attention_pool as jax_gated_attention_pool
from madeleine_torch.config import MadeleineConfig
from madeleine_torch.models.abmil import (drop_kernel_operands, encoder_weights, gate_weights,
                                          kernel_operands, pre_attn_mlp)
from madeleine_torch.models.madeleine import MADELEINE, _project
from madeleine_torch.ops import gated_pool as gp
from madeleine_torch.ops.attn_pool import mask_bias
from tests.torch_port_helpers import (GOLDEN_DIR, configs, flagship_state_dict, jax_params,
                                      port_model, ragged_mask, to_torch)

TOL = dict(rtol=1e-4, atol=1e-5)   # the f32 route's bars against JAX and the golden fixtures
MIRROR_TOL = dict(rtol=1e-5, atol=1e-5)   # the split's arithmetic against the plain f32 products
PEAK_WC_SCALE = 16.0   # as chip_smoke.py: attention logits spread by several units


@torch.no_grad()
def k2_mirror(y, bias, wa, ba, wb, bb, wc, bc, tile_rows=gp.TILE_ROWS, lo_terms=True):
    """The kernel's arithmetic in PyTorch: per 32-deep k tile the partial
    (y_lo W_hi + y_hi W_lo) + y_hi W_hi (f32 sums of exact TF32 products,
    small terms first; y_hi W_hi alone where not lo_terms, the control of
    a kernel that loses the lo halves), the partials added in k order, on K6's permuted
    [Wa; Wb], plus the permuted bias; per 64-column chunk the sum
    of tanh . sigmoid . wc; the chunks added in order, then bc and the mask
    bias; per tile of `tile_rows` tokens the softmax partial (m, s, w) over
    the tokens below t, a tile with no unmasked token (-inf, 0, 0); the
    tiles merged in order as csrc/pool_combine.cuh does."""
    b, t, E = y.shape
    nh, f, e = wa.shape
    ops = gp.split_operands(wa, ba, wb, bb, wc, bc)
    y_hi, y_lo = gp.split_tf32(y.reshape(b, t, nh, e))
    if not lo_terms:
        y_lo, ops["wab_lo"] = torch.zeros_like(y_lo), torch.zeros_like(ops["wab_lo"])

    def prod(a, w):
        return torch.einsum("bthe,hne->bthn", a, w)

    z = None
    for k0 in range(0, e, gp.K_TILE):
        k = slice(k0, k0 + gp.K_TILE)
        hi, lo = ops["wab_hi"][..., k], ops["wab_lo"][..., k]
        part = (prod(y_lo[..., k], hi) + prod(y_hi[..., k], lo)) + prod(y_hi[..., k], hi)
        z = part if z is None else z + part
    z = z + ops["bab"]
    z = z.reshape(b, t, nh, f // gp.GATE_CHUNK, 2, gp.GATE_CHUNK)
    part = (torch.tanh(z[..., 0, :]) * torch.sigmoid(z[..., 1, :])
            * wc.reshape(nh, f // gp.GATE_CHUNK, gp.GATE_CHUNK)).sum(-1)
    logits = part[..., 0]
    for c in range(1, part.shape[-1]):
        logits = logits + part[..., c]
    logits = logits + bc + bias                                   # [b, t, nh]

    ntiles = -(-t // tile_rows)
    pad = ntiles * tile_rows - t
    lt = torch.cat([logits, torch.full((b, pad, nh), -torch.inf)], 1)
    yt = torch.cat([y, torch.zeros(b, pad, E)], 1).reshape(b, ntiles, tile_rows, nh, e)
    bt = torch.cat([bias, torch.full((b, pad, nh), -1e30)], 1)
    lt, bt = lt.reshape(b, ntiles, tile_rows, nh), bt.reshape(b, ntiles, tile_rows, nh)
    live = (bt > -1e29).any(2)                                   # [b, ntiles, nh]
    m = lt.amax(2)
    p = torch.exp(lt - m[:, :, None])
    s = p.sum(2)
    w = torch.einsum("bkrh,bkrhe->bkhe", p, yt)
    m = torch.where(live, m, torch.full_like(m, -torch.inf))
    s = torch.where(live, s, torch.zeros_like(s))
    w = torch.where(live[..., None], w, torch.zeros_like(w))
    M = m.amax(1)                                                # [b, nh]
    a = torch.where(torch.isfinite(m), torch.exp(m - M[:, None]), torch.zeros_like(m))
    S, W = (s * a).sum(1), (w * a[..., None]).sum(1)
    out = W / S.clamp_min(1e-30)[..., None]
    out = torch.where(torch.isfinite(M)[..., None], out, torch.zeros_like(out))
    return out.reshape(b, E)


# ---------------------------------------------------------------------------
# the TF32 split
# ---------------------------------------------------------------------------

def _tf32_reference(x: np.ndarray) -> np.ndarray:
    """Nearest TF32 value (10 mantissa bits), ties away from zero, in float64."""
    mant, expo = np.frexp(np.abs(x.astype(np.float64)))      # |x| = mant 2^expo, mant in [0.5, 1)
    q = np.floor(mant * 2.0 ** 11 + 0.5)                     # 11 significant bits
    return np.sign(x) * np.ldexp(q, expo - 11)


def test_tf32_split_rounds_to_nearest_ties_away_and_keeps_22_bits():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(4096) * 10.0 ** rng.integers(-20, 20, 4096),
                        rng.uniform(-1, 1, 4096)]).astype(np.float32)
    # exact ties: the dropped 13 bits are 1000...0, both signs
    ties = (rng.integers(0x3F800000, 0x40800000, 512, dtype=np.int64) & ~0x1FFF) | 0x1000
    ties = ties.astype(np.uint32).view(np.float32)
    x = np.concatenate([x, ties, -ties]).astype(np.float32)
    xt = torch.from_numpy(x)
    hi, lo = gp.split_tf32(xt)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    np.testing.assert_array_equal(hi.numpy().astype(np.float64), _tf32_reference(x))
    tie_hi = gp.round_tf32(torch.from_numpy(ties)).numpy()
    assert (np.abs(tie_hi) > np.abs(ties)).all()             # away from zero
    np.testing.assert_array_equal(gp.round_tf32(torch.from_numpy(-ties)).numpy(), -tie_hi)
    err = np.abs(hi.numpy().astype(np.float64) + lo.numpy() - x)
    assert (err <= 2.0 ** -21 * np.abs(x)).all()
    # the operands the kernel reads: each split half of the permuted weights
    wa, wb = (torch.from_numpy(rng.standard_normal((2, 128, 64)).astype(np.float32))
              for _ in range(2))
    ba, bb = torch.zeros(2, 128), torch.ones(2, 128)
    ops = gp.split_operands(wa, ba, wb, bb, torch.ones(2, 128), torch.ones(2))
    wab = torch.cat([wa.reshape(2, 2, 64, 64), wb.reshape(2, 2, 64, 64)], 2).reshape(2, 256, 64)
    torch.testing.assert_close(ops["wab_hi"] + ops["wab_lo"], wab, rtol=2.0 ** -21, atol=0)
    assert torch.equal(ops["bab"], torch.cat([ba.reshape(2, 2, 64), bb.reshape(2, 2, 64)],
                                             2).reshape(2, 256))


# ---------------------------------------------------------------------------
# the mirror against the plain version and JAX
# ---------------------------------------------------------------------------

# (seed, b, t, nh, hidden, f, lengths, wc scale)
CASES = {
    "peaked": (0, 2, 256, 2, 128, 128, None, PEAK_WC_SCALE),
    "partial_last_tile": (1, 3, 300, 2, 64, 64, [300, 129, 77], 1.0),
    "all_masked_bag": (2, 3, 200, 2, 128, 64, [200, 0, 31], PEAK_WC_SCALE),
}


def _setup(seed, b, t, nh, hidden, f, lengths, scale):
    jcfg, cfg = configs(wsi_encoder_hidden_dim=hidden, n_heads=nh, attention_hidden_dim=f)
    params = jax_params(jcfg, seed)
    attn = params["wsi_embedders"]["attn"]
    attn["wc"] = (attn["wc"] * scale).astype(np.float32)
    model = port_model(cfg, params)
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((b, t, nh, hidden)).astype(np.float32)
    mask = None if lengths is None else ragged_mask(lengths, t)
    return attn, model, xh, mask


@pytest.mark.parametrize("case", list(CASES))
def test_mirror_matches_plain_and_jax_interpret(case):
    """The split's arithmetic at 1e-5 of the plain f32 products, and at the
    f32 route's bars of JAX's interpret-mode kernel. Peaked: wc scaled so
    the logits spread by several units, with the controls that a uniform
    pool and the mirror without its lo terms (plain TF32) miss the bar; a
    partial last 128-token tile; a bag with no valid token
    pools to 0 (the port's rule)."""
    seed, b, t, nh, hidden, f, lengths, scale = CASES[case]
    attn, model, xh, mask = _setup(*CASES[case])
    w = {k: v.detach().float().contiguous() for k, v in gate_weights(model.wsi_embedders).items()}
    y = to_torch(xh).reshape(b, t, nh * hidden)
    bias = mask_bias(None if mask is None else torch.from_numpy(mask), b, t, nh,
                     torch.device("cpu"))
    got = k2_mirror(y, bias, **w)
    want = gp.gated_attention_pool_plain(y, bias, **w)
    torch.testing.assert_close(got, want, **MIRROR_TOL)
    jax_out = np.asarray(jax_gated_attention_pool(
        jax.tree_util.tree_map(jnp.asarray, attn), jnp.asarray(xh),
        None if mask is None else jnp.asarray(mask), t_block=64, interpret=True))
    live = [i for i in range(b) if lengths is None or lengths[i] > 0]
    np.testing.assert_allclose(got.numpy()[live], jax_out.reshape(b, -1)[live], **TOL)
    for i in set(range(b)) - set(live):
        assert (got[i] == 0).all()
    if case == "peaked":
        yh = y.reshape(b, t, nh, hidden)
        a = torch.tanh(torch.einsum("bthe,hfe->bthf", yh, w["wa"]) + w["ba"])
        g = torch.sigmoid(torch.einsum("bthe,hfe->bthf", yh, w["wb"]) + w["bb"])
        logits = torch.einsum("bthf,hf->bth", a * g, w["wc"])
        assert (logits.amax(1) - logits.amin(1)).min() > 3.0
        uniform = gp.gated_attention_pool_plain(y, bias, **dict(w, wc=torch.zeros_like(w["wc"])))
        assert (uniform - want).abs().max() > TOL["atol"] + TOL["rtol"] * want.abs().max()
        hi_only = k2_mirror(y, bias, **w, lo_terms=False)
        assert ((hi_only - want).abs() > TOL["atol"] + TOL["rtol"] * want.abs()).any()


def test_golden_flagship_encode_he_through_the_mirror():
    """golden_flagship.npz's f32 encode_he (the published widths: 512-d in,
    hidden 512, 4 heads, attention 512) by the f32 kernel route, with the
    gates and pool as the split kernel computes them."""
    gold = np.load(os.path.join(GOLDEN_DIR, "golden_flagship.npz"))
    model = MADELEINE(MadeleineConfig(precision="float32", dataset="ACROBAT").finalize())
    model.load_state_dict({k: torch.from_numpy(v) for k, v in flagship_state_dict().items()},
                          strict=True)
    model.eval()
    emb = model.wsi_embedders
    x = to_torch(gold["fs/encode_he/in"])
    b, t, _ = x.shape
    with torch.no_grad():
        w = encoder_weights(emb)
        y = pre_attn_mlp(w, x)
        bias = mask_bias(None, b, t, emb.n_heads, torch.device("cpu"))
        pooled = k2_mirror(y, bias, **{k: w[k].float().contiguous() for k in
                                       ("wa", "ba", "wb", "bb", "wc", "bc")})
        got = _project(model, pooled.reshape(b, emb.n_heads, emb.hidden_dim))
    np.testing.assert_allclose(got.numpy(), gold["fs/encode_he/out"], **TOL)


# ---------------------------------------------------------------------------
# the split operands, once per weight state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["foreach", "fused"])
def test_split_operands_rebuild_after_an_optimizer_step(impl):
    """kernel_operands in f32 keeps the split of the permuted gates, beside
    the bf16 set. An
    AdamW step changes the weights in place: the multi-tensor step moves
    their versions and the cache rebuilds; the fused step moves none, and
    drop_kernel_operands (the trainer's call after every update) makes it
    rebuild. The new split equals one built fresh and differs from the old."""
    _, cfg = configs()
    model = port_model(cfg, jax_params(configs()[0], 5))
    emb = model.wsi_embedders
    first = kernel_operands(emb, torch.float32)
    assert kernel_operands(emb, torch.float32) is first
    bf16 = kernel_operands(emb, torch.bfloat16)   # one set per dtype: neither evicts the other
    assert kernel_operands(emb, torch.float32) is first
    assert kernel_operands(emb, torch.bfloat16) is bf16
    fresh0 = gp.split_operands(**gate_weights(emb))
    for k, v in fresh0.items():
        assert torch.equal(first[k], v), k
    opt = torch.optim.AdamW(emb.parameters(), lr=1e-2, **{impl: True})
    for p in emb.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    if impl == "fused":
        drop_kernel_operands(model)
    second = kernel_operands(emb, torch.float32)
    assert second is not first
    fresh = gp.split_operands(**gate_weights(emb))
    for k, v in fresh.items():
        assert torch.equal(second[k], v), k
    assert not torch.equal(second["wab_hi"], first["wab_hi"])
    drop_kernel_operands(model)
    assert "_kernel_operands" not in emb.__dict__


def test_split_wrappers_refuse_cpu_tensors_and_count_nothing():
    """Both K2 entry points raise on CPU tensors (no plain fallback) and
    leave their launch counts alone; the model's CPU route is the plain one.
    The split design takes the weights' split operands only."""
    attn, model, xh, mask = _setup(*CASES["partial_last_tile"])
    b, t, nh, e = xh.shape
    w = {k: v.detach().float().contiguous() for k, v in gate_weights(model.wsi_embedders).items()}
    y = to_torch(xh).reshape(b, t, nh * e)
    bias = mask_bias(None, b, t, nh, torch.device("cpu"))
    before = (gp.launches, gp.ffma_launches)
    with pytest.raises(ValueError, match="CUDA"):
        gp.gated_pool_ffma_cuda(y, bias, **w)
    with pytest.raises(ValueError, match="CUDA"):
        gp.gated_pool_cuda(y, bias, **gp.split_operands(**w))
    with pytest.raises(TypeError):
        gp.gated_pool_cuda(y, bias, **w)
    assert (gp.launches, gp.ffma_launches) == before
