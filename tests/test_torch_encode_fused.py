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
    got = ef.encode_pool_fused(ef.kernel_weights(encoder_weights(model.wsi_embedders), tdt),
                               to_torch(x, tdt), None if mask is None else torch.from_numpy(mask))
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
    k1 = ef.encode_pool_fused(ef.kernel_weights(w, torch.float32), to_torch(x), mask)
    torch.testing.assert_close(k1, plain, rtol=1e-4, atol=1e-5)
    y = pre_attn_mlp(w, to_torch(x)).reshape(B, T, emb.n_heads, emb.hidden_dim)
    k2 = gated_attention_pool(w, y, mask)
    torch.testing.assert_close(k2, plain, rtol=1e-4, atol=1e-5)


def test_bag_without_tokens_pools_to_zero():
    """As in the kernel, which skips tiles with no unmasked token; the
    composable route gives 0 there too."""
    _, model, x = _setup(seed=4)
    mask = torch.from_numpy(ragged_mask([200, 0, 31], T))
    w = ef.kernel_weights(encoder_weights(model.wsi_embedders), torch.bfloat16)
    out = ef.encode_pool_fused(w, to_torch(x, torch.bfloat16), mask)
    assert torch.isfinite(out.float()).all()
    assert (out[1] == 0).all() and (out[0] != 0).any()
    plain = abmil_embed(model.wsi_embedders, to_torch(x), mask=mask)
    assert (plain[1] == 0).all()


def test_cpu_tensor_takes_plain_version_and_counts_nothing():
    _, model, x = _setup(seed=5)
    before = ef.launches
    w = ef.kernel_weights(encoder_weights(model.wsi_embedders), torch.bfloat16)
    ef.encode_pool_fused(w, to_torch(x, torch.bfloat16))
    assert ef.launches == before


def test_kernel_entry_rejects_cpu_tensors():
    _, model, x = _setup(seed=6)
    w = ef.kernel_weights(encoder_weights(model.wsi_embedders), torch.bfloat16)
    bias = mask_bias(None, B, T, 2, torch.device("cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        ef.encode_fused_cuda(to_torch(x, torch.bfloat16), bias, w)


# ---------------------------------------------------------------------------
# the live-tile route (ef.encode_fused_cuda on the card): its device-side
# decisions and its order, mirrored on the CPU
# ---------------------------------------------------------------------------

TM = ef.TILE_ROWS


def _head_masks(case):
    """(t, per-head validity [b, t, nh]) of each live-tile case: ragged
    bags, an empty bag, every bag empty, a tile live in one head only (bag
    0's tile 2 holds tokens valid in head 1 alone, its tile 1 none), and a
    partial last tile (t = 4057: 63 tiles of 64 and one of 25)."""
    nh = 2
    if case == "t4057":
        t, lengths = 4057, [4057, 100]
    elif case == "one_head":
        t = T
        m = np.zeros((B, t, nh), bool)
        m[0, :64, 0] = True
        m[0, 130:141, 1] = True
        m[1, :200] = True
        m[2, 5:9, 0] = True
        m[2, 5:9, 1] = True
        return t, m
    else:
        t = T
        lengths = {"ragged": [200, 133, 70], "empty": [200, 0, 31], "all_masked": [0, 0, 0]}[case]
    m = ragged_mask(lengths, t)
    return t, np.repeat(m[..., None], nh, axis=2)


def _bias_of(valid):
    return torch.where(torch.from_numpy(valid), 0.0, -1e30).to(torch.float32)


LIVE_CASES = ["ragged", "empty", "all_masked", "one_head", "t4057"]


@pytest.mark.parametrize("case", LIVE_CASES)
@pytest.mark.parametrize("budget", [ef.ROW_BUDGET, 2 * TM], ids=["budget", "two_tile_chunks"])
def test_live_tile_list_matches_the_mask(case, budget):
    """live_tiles_plain (the plain version of tile_flags + live_scan): a tile
    slot is live exactly when one of its tokens is valid in some head; the
    list holds the live slots in slot order, and each chunk's live rows are
    TM x its share of the list (chunks of budget / TM entries)."""
    t, valid = _head_masks(case)
    b = valid.shape[0]
    flags, live, rows = ef.live_tiles_plain(_bias_of(valid), budget)
    ntiles = -(-t // TM)
    want = [bool(valid[s // ntiles, (s % ntiles) * TM:(s % ntiles + 1) * TM].any())
            for s in range(b * ntiles)]
    assert flags.tolist() == want
    assert live.tolist() == [s for s, f in enumerate(want) if f]
    slots, cap, nchunks, scratch = ef.chunk_plan(b, t, budget)
    assert (slots, cap) == (b * ntiles, budget // TM) and nchunks == -(-slots // cap)
    assert scratch == TM * min(cap, slots)
    n = len(live)
    assert rows.tolist() == [TM * min(cap, max(0, n - c * cap)) for c in range(nchunks)]
    if case == "one_head":
        assert want[:4] == [True, False, True, False]


def _tiles_route_mirror(x, bias, w, budget):
    """The live-tile route in f32 on the CPU, in its own order: the live
    tiles gathered chunk by chunk (rows past t as zeros), the three layers
    on the compact rows, the gates on the permuted [Wa; Wb] with one logit
    partial per 64 gate columns added in chunk order, then bc and the mask
    bias, each live tile's softmax-pool partial (m, s, w) at its slot, dead
    slots empty, and the combine of pool_combine.cuh in slot order."""
    b, t, d_in = x.shape
    nh, f, e = w["wa"].shape
    E = nh * e
    ntiles = -(-t // TM)
    _, live, _ = ef.live_tiles_plain(bias, budget)
    slots, cap, nchunks, _ = ef.chunk_plan(b, t, budget)
    part_m = torch.full((slots, nh), float("-inf"))
    part_s = torch.zeros(slots, nh)
    part_w = torch.zeros(slots, E)
    for c in range(nchunks):
        lst = live[c * cap:(c + 1) * cap].tolist()
        if not lst:
            continue
        xc = torch.zeros(len(lst) * TM, d_in)
        rows_of = []
        for k, slot in enumerate(lst):
            bi, tok0 = slot // ntiles, (slot % ntiles) * TM
            rows = min(TM, t - tok0)
            xc[k * TM:k * TM + rows] = x[bi, tok0:tok0 + rows]
            rows_of.append((bi, tok0, rows))
        h = xc
        for i in (1, 2, 3):
            z = h @ w[f"w{i}"].T + w[f"b{i}"]
            h = torch.nn.functional.gelu(torch.nn.functional.layer_norm(
                z, z.shape[-1:], w[f"s{i}"], w[f"t{i}"], ef.LN_EPS))
        y32 = h
        lpart = torch.zeros(len(lst) * TM, nh, f // 64)
        for hd in range(nh):
            g = y32[:, hd * e:(hd + 1) * e] @ w["wab"][hd].T + w["bab"][hd]   # [R, 2f] permuted
            for q in range(f // 64):
                a = torch.tanh(g[:, 128 * q:128 * q + 64])
                s = torch.sigmoid(g[:, 128 * q + 64:128 * q + 128])
                lpart[:, hd, q] = (a * s * w["wc"][hd, 64 * q:64 * q + 64]).sum(1)
        for k, (bi, tok0, rows) in enumerate(rows_of):
            slot = lst[k]
            for hd in range(nh):
                l = torch.zeros(rows)
                for q in range(f // 64):
                    l = l + lpart[k * TM:k * TM + rows, hd, q]
                l = l + w["bc"][hd] + bias[bi, tok0:tok0 + rows, hd]
                m = l.max()
                p = torch.exp(l - m)
                part_m[slot, hd], part_s[slot, hd] = m, p.sum()
                part_w[slot, hd * e:(hd + 1) * e] = p @ y32[k * TM:k * TM + rows, hd * e:(hd + 1) * e]
    out = torch.zeros(b, E)
    for bi in range(b):
        pm, ps, pw = (a[bi * ntiles:(bi + 1) * ntiles] for a in (part_m, part_s, part_w))
        M = pm.max(0).values                                  # [nh]
        for hd in range(nh):
            if M[hd] == float("-inf"):
                continue
            a = torch.exp(pm[:, hd] - M[hd])
            S = (ps[:, hd] * a).sum().clamp_min(1e-30)
            out[bi, hd * e:(hd + 1) * e] = (pw[:, hd * e:(hd + 1) * e] * a[:, None]).sum(0) / S
    return out


@pytest.mark.parametrize("case", ["ragged", "empty", "one_head", "t4057"])
@pytest.mark.parametrize("budget", [ef.ROW_BUDGET, 2 * TM], ids=["budget", "two_tile_chunks"])
def test_live_tile_route_order_matches_the_plain_version(case, budget):
    """The mirror of the live-tile route equals encode_pool_fused_plain in
    f32 (rtol 1e-5, atol 1e-6: only the order of sums differs), with the
    gates read through the permuted operands of kernel_weights; an empty bag
    pools to 0. Chunks of two tiles split bags across chunks."""
    t, valid = _head_masks(case)
    b = valid.shape[0]
    _, model, _ = _setup(seed=7)
    w = ef.kernel_weights(encoder_weights(model.wsi_embedders), torch.float32)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (b, t, model.wsi_embedders.pre_attn[0].in_features)).astype(np.float32))
    bias = _bias_of(valid)
    got = _tiles_route_mirror(x, bias, w, budget)
    want = ef.encode_pool_fused_plain(x, bias, w)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    for bi in range(b):
        if not valid[bi].any():
            assert (got[bi] == 0).all() and (want[bi] == 0).all()


def test_chunk_plan_keeps_the_scratch_within_the_budget():
    """One chunk holds the timing shape (8 x 4096 token slots), an extracted
    bag of 9000 tokens and serving's batches up to 32,768 token slots;
    serving's largest bucket (65,536 tokens) at its largest power-of-two
    batch (32) runs as 64 chunks. The scratch never passes ROW_BUDGET rows:
    about 0.41 GB at the published widths."""
    assert ef.chunk_plan(8, 4096) == (512, 512, 1, 32768)
    assert ef.chunk_plan(1, 9000) == (141, 512, 1, 9024)
    assert ef.chunk_plan(32, 65536) == (32768, 512, 64, ef.ROW_BUDGET)
    for b, t in ((1, 512), (16, 16384), (32, 65536), (1, 70000)):
        assert ef.chunk_plan(b, t)[3] <= ef.ROW_BUDGET
    nh, e, f, d_in = 4, 512, 512, 704
    gb = ef.ROW_BUDGET * (4 * nh * e + 2 * max(nh * e, 2 * e + d_in) + 4 * nh * f // 64) / 1e9
    assert 0.40 < gb < 0.42


def test_kernel_weights_hold_the_permuted_gates():
    """wab / bab are [Wa; Wb] and [ba; bb] in K6's gate-product row order
    (encoder_train.gate_perm), so K1's gate epilogue reads what K6's does."""
    from madeleine_torch.ops.encoder_train import gate_perm

    _, model, _ = _setup(seed=9)
    w = ef.kernel_weights(encoder_weights(model.wsi_embedders), torch.float32)
    perm = gate_perm(w["wa"].shape[1])
    torch.testing.assert_close(w["wab"], torch.cat([w["wa"], w["wb"]], 1)[:, perm], rtol=0, atol=0)
    torch.testing.assert_close(w["bab"], torch.cat([w["ba"], w["bb"]], 1)[:, perm], rtol=0, atol=0)


def test_kernel_operands_are_built_once_per_weight_state():
    """abmil.kernel_operands returns the same operands until a parameter
    changes in place, then builds them anew from the new weights."""
    from madeleine_torch.models.abmil import kernel_operands

    _, model, _ = _setup(seed=10)
    emb = model.wsi_embedders
    first = kernel_operands(emb, torch.bfloat16)
    assert kernel_operands(emb, torch.bfloat16) is first
    with torch.no_grad():
        emb.pre_attn[0].weight.mul_(2.0)
    second = kernel_operands(emb, torch.bfloat16)
    assert second is not first
    torch.testing.assert_close(second["w1"], (2.0 * first["w1"].float()).to(torch.bfloat16))


@pytest.mark.parametrize("impl", ["foreach", "fused"])
def test_kernel_operands_rebuild_after_an_optimizer_step(impl):
    """An AdamW step changes the parameters in place. After the multi-tensor
    step (the card's default) kernel_operands sees the new versions and
    rebuilds; the fused step moves no version counter, so only
    drop_kernel_operands (the trainer's call after each update) makes it
    rebuild. Either way it then equals operands built fresh."""
    from madeleine_torch.models.abmil import drop_kernel_operands, kernel_operands

    _, model, x = _setup(seed=12)
    emb = model.wsi_embedders
    first = kernel_operands(emb, torch.bfloat16)
    opt = torch.optim.AdamW(emb.parameters(), lr=1e-2, **{impl: True})
    abmil_embed(emb, to_torch(x)).square().sum().backward()
    opt.step()
    if impl == "fused":
        drop_kernel_operands(model)
    second = kernel_operands(emb, torch.bfloat16)
    assert second is not first
    fresh = ef.kernel_weights(encoder_weights(emb), torch.bfloat16)
    for k, v in fresh.items():
        torch.testing.assert_close(second[k], v, rtol=0, atol=0)
    assert not torch.equal(second["w1"], first["w1"])
    drop_kernel_operands(model)
    assert "_kernel_operands" not in emb.__dict__
    assert kernel_operands(emb, torch.bfloat16) is not second


def test_k1_wrappers_refuse_cpu_tensors_and_count_nothing():
    """Both K1 entry points raise on CPU tensors (no plain fallback) and
    leave their launch counts alone."""
    _, model, x = _setup(seed=11)
    w = ef.kernel_weights(encoder_weights(model.wsi_embedders), torch.bfloat16)
    bias = mask_bias(None, B, T, 2, torch.device("cpu"))
    before = (ef.launches, ef.rowtile_launches)
    for call in (ef.encode_fused_cuda, ef.encode_fused_rowtile_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            call(to_torch(x, torch.bfloat16), bias, w)
    assert (ef.launches, ef.rowtile_launches) == before
