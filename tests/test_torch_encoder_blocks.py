"""The whole-encoder op in blocks of whole bags (madeleine_torch/ops/
encoder_train.py: `encoder_blocks`, `encoder_train_fwd_blocks`,
`encoder_train_bwd_blocks`, `encoder_train(..., block_bags=)`) on the CPU,
where each block runs the plain versions of K6/K7: against the JAX
package's `encoder_train` (interpret mode, rates 0) on both save routes,
need_dx off and on, n_views 1 and 3; against the unblocked call at the
real dropout rates (the forward and dx bit for bit, a block given a
shifted row offset missing); the block rule at the published widths; the
blocked-call counters and the recompute switch."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madeleine_torch.models.madeleine import train_weights
from madeleine_torch.ops import encoder_train as et
from madeleine_torch.ops import launches
from tests.torch_port_helpers import grads_as_state_dict, param_pair, ragged_mask, to_torch

B, T, D, NH, E = 5, 96, 128, 2, 128
LENGTHS = [96, 41, 96, 96, 96]
SEED = 7
BLOCK_BAGS = 2   # blocks (0, 2), (2, 4), (4, 5)
TOL = dict(rtol=1e-4, atol=1e-5)
# the published widths: d_in, hidden, heads, head width, gate width, d_out
WIDTHS = (512, 512, 4, 512, 512, 128)


@functools.lru_cache(maxsize=None)
def _setup():
    _, _, params, model = param_pair(seed=1, patch_embedding_dim=D, wsi_encoder_hidden_dim=E,
                                     n_heads=NH, attention_hidden_dim=E)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    half = np.zeros(T, bool)
    half[rng.permutation(T)[:T // 2]] = True
    return params, model, x, ragged_mask(LENGTHS, T), half


def _loss_torch(pooled, tok):
    return torch.sin(pooled).sum() + (torch.cos(tok) * 0.01).sum()


@functools.lru_cache(maxsize=None)
def _jax_reference(need_dx, n_views):
    """JAX's op in interpret mode at rates 0: (pooled, tok, {name: gradient})."""
    from madeleine_tpu.ops.encoder_train import encoder_train as jax_op

    params, _, x, mask, half = _setup()

    def loss(xx, pre, attn, tokp):
        p, tk = jax_op(xx, pre, attn, tokp, jnp.asarray(mask), jnp.int32(SEED), 0.0, 0.0, 32,
                       need_dx, False, jnp.asarray(half) if n_views == 3 else None)
        return jnp.sum(jnp.sin(p)) + jnp.sum(jnp.cos(tk) * 0.01), (p, tk)

    emb = params["wsi_embedders"]
    (_, (p, tk)), g = jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(
        jnp.asarray(x), emb["pre_attn"], emb["attn"], params["token_projector"])
    want = {k: v.numpy() for k, v in grads_as_state_dict(
        {"wsi_embedders": {"pre_attn": g[1], "attn": g[2]}, "token_projector": g[3]},
        params).items()}
    if need_dx:
        want["x"] = np.asarray(g[0])
    return np.asarray(p), np.asarray(tk), want


def _port(need_dx, n_views, save=None, rates=(0.0, 0.0), row_offset=0, block_bags=None):
    """The port's op on the shared inputs: (pooled, tok, {name: gradient})."""
    _, model, x, mask, half = _setup()
    model.zero_grad()
    xt = to_torch(x).requires_grad_(need_dx)
    pooled, tok = et.encoder_train(
        xt, torch.from_numpy(mask), train_weights(model, torch.float32), SEED, *rates,
        row_offset=row_offset, need_dx=need_dx,
        half_mask=torch.from_numpy(half) if n_views == 3 else None, save_acts=save,
        block_bags=block_bags)
    _loss_torch(pooled, tok).backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}
    if need_dx:
        grads["x"] = xt.grad.clone()
    return pooled.detach(), tok.detach(), grads


@pytest.mark.parametrize("n_views", [1, 3], ids=["one_view", "three_views"])
@pytest.mark.parametrize("need_dx", [False, True], ids=["no_dx", "dx"])
@pytest.mark.parametrize("save", [True, False], ids=["save", "recompute"])
def test_blocked_op_equals_jax(save, need_dx, n_views):
    """block_bags 2 (blocks of 2, 2 and 1 bags; one bag 41 of 96 tokens) at
    rates 0 against JAX's encoder_train in interpret mode: pooled and
    tokens at rtol 1e-4 / atol 1e-5, every gradient (and dx) at rtol 1e-4 /
    atol 1e-5 x its largest entry."""
    before = launches.read()
    pooled, tok, grads = _port(need_dx, n_views, save=save, block_bags=BLOCK_BAGS)
    after = launches.read()
    assert after["encoder_train_fwd_blocks"] - before["encoder_train_fwd_blocks"] == 3
    assert after["encoder_train_bwd_blocks"] - before["encoder_train_bwd_blocks"] == 3
    want_p, want_t, want_g = _jax_reference(need_dx, n_views)
    np.testing.assert_allclose(pooled.numpy(), want_p, **TOL)
    np.testing.assert_allclose(tok.numpy(), want_t, **TOL)
    assert set(grads) <= set(want_g)
    for k, g in grads.items():
        scale = max(1.0, float(np.abs(want_g[k]).max()))
        np.testing.assert_allclose(g.numpy(), want_g[k], rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=k)


@pytest.mark.parametrize("save", [True, False], ids=["save", "recompute"])
def test_blocked_op_equals_unblocked_at_real_rates(save, monkeypatch):
    """At the real dropout rates and row offset 3, with dx: blocks of 2, 2
    and 1 bags give the unblocked call's pooled, tokens and dx bit for bit
    (each block draws its bags' masks at its global rows) and every weight
    gradient within 1e-5 x its largest entry (the blocks' sums added in
    block order; bc, whose exact gradient is 0, within 1e-5). Control: the
    middle block at a row offset shifted by one moves its bags' pooled
    outputs past that bar and leaves the others."""
    rates = (et.PRE_RATE, et.GATE_RATE)
    assert min(rates) > 0
    one = _port(True, 1, save=save, rates=rates, row_offset=3)
    blk = _port(True, 1, save=save, rates=rates, row_offset=3, block_bags=BLOCK_BAGS)
    assert torch.equal(one[0], blk[0]) and torch.equal(one[1], blk[1])
    assert torch.equal(one[2]["x"], blk[2]["x"])
    assert one[2].keys() == blk[2].keys()
    for k, g in one[2].items():
        # bc's exact gradient is 0 (softmax shift invariance): both calls hold
        # rounding noise there, held to 1e-5 absolutely
        scale = 1.0 if k.endswith("attention_c.bias") else float(g.abs().max())
        assert float((blk[2][k] - g).abs().max()) <= 1e-5 * scale, k

    plain = et.encoder_train_fwd_plain

    def shifted(x, bias, w, seed, row_offset, *args, **kw):
        return plain(x, bias, w, seed, row_offset + (row_offset == 3 + 2), *args, **kw)

    monkeypatch.setattr(et, "encoder_train_fwd_plain", shifted)
    _, model, x, mask, _ = _setup()
    with torch.no_grad():
        ctl = et.encoder_train(to_torch(x), torch.from_numpy(mask),
                               train_weights(model, torch.float32), SEED, *rates, row_offset=3,
                               save_acts=save, block_bags=BLOCK_BAGS)[0]
    diff = (ctl - one[0]).abs().reshape(B, -1).amax(1)
    assert torch.equal(diff[[0, 1, 4]], torch.zeros(3))
    assert float(diff[2:4].min()) > 1e-3


def _cases():
    GB = 10 ** 9
    return {
        # the calls the smoke run made before blocks existed: one block each
        "step_bf16": (65, 2048, torch.bfloat16, False, 1),
        "step_f32": (65, 2048, torch.float32, False, 1),
        "ragged_16384_bf16_recompute": (65, 16384, torch.bfloat16, True, 1),
        "ragged_8192_f32_recompute": (65, 8192, torch.float32, True, 1),
        # grown buckets and f32 at 16384: two blocks of 33 and 32 bags
        "grown_32768_bf16_recompute": (65, 32768, torch.bfloat16, True, 2),
        "ragged_16384_f32_recompute": (65, 16384, torch.float32, True, 2),
        # a card with 40 GB left: more blocks of fewer bags
        "limit_40gb_32768_bf16": (65, 32768, torch.bfloat16, True, 3, 40 * GB),
    }


@pytest.mark.parametrize("case", list(_cases()))
def test_encoder_blocks_rule(case):
    """The block rule at the published widths: the blocks are contiguous,
    cover [0, b), differ in size by at most one bag, and each holds its
    transient bytes under the budget (and the limit less BLOCK_MARGIN); the
    published steps' calls stay one block."""
    b, t, dtype, recompute, n_blocks, *limit = _cases()[case]
    limit = limit[0] if limit else None
    blocks = et.encoder_blocks(b, t, WIDTHS, dtype, recompute, limit)
    assert len(blocks) == n_blocks
    assert blocks[0][0] == 0 and blocks[-1][1] == b
    assert all(p[1] == q[0] for p, q in zip(blocks, blocks[1:]))
    sizes = [b1 - b0 for b0, b1 in blocks]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    per_row = et._block_row_bytes(WIDTHS, torch.empty((), dtype=dtype).element_size(),
                                  recompute)
    cap = et.BLOCK_BUDGET_BYTES if limit is None else limit - et.BLOCK_MARGIN
    assert max(sizes) * t * per_row <= cap
    # fewer blocks would not fit
    assert -(-b // (n_blocks - 1 or 1)) * t * per_row > cap or n_blocks == 1


def test_encoder_blocks_raises_when_one_bag_does_not_fit():
    """A bag of 2**21 tokens (93 GB of transient buffers in bf16 on the
    recompute route) cannot be a block: the rule raises rather than guess."""
    with pytest.raises(MemoryError, match="one bag"):
        et.encoder_blocks(65, 2 ** 21, WIDTHS, torch.bfloat16, True)
    with pytest.raises(MemoryError, match="one bag"):
        et.encoder_blocks(2, 2048, WIDTHS, torch.float32, False, limit=et.BLOCK_MARGIN)


def test_forced_blocks_are_counted_and_the_recompute_switch_reaches_every_block(monkeypatch):
    """block_bags 2 on a call of 5 bags: the counters show one blocked
    forward and one blocked backward of 3 blocks each; with
    MADELEINE_ENCODER_NO_SAVE_ACTS set every block's forward keeps no
    residuals and every block's backward rebuilds them, and the gradients
    equal the save route's blocked call bit for bit."""
    seen = []
    fwd, bwd = et.encoder_train_fwd_plain, et.encoder_train_bwd_plain

    def fwd_spy(*args, save=True, **kw):
        seen.append(("fwd", save))
        return fwd(*args, save=save, **kw)

    def bwd_spy(x, l, m, s, g, inner, dtok, saved, *args, **kw):
        seen.append(("bwd", saved is not None))
        return bwd(x, l, m, s, g, inner, dtok, saved, *args, **kw)

    monkeypatch.setattr(et, "encoder_train_fwd_plain", fwd_spy)
    monkeypatch.setattr(et, "encoder_train_bwd_plain", bwd_spy)
    out = {}
    for env in ("", "1"):
        monkeypatch.setenv(et.NO_SAVE_VAR, env)
        seen.clear()
        before = launches.read()
        out[env] = _port(False, 1, save=True, block_bags=BLOCK_BAGS)[2]
        after = launches.read()
        counts = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        assert counts == {"encoder_train_fwd_blocked_calls": 1, "encoder_train_fwd_blocks": 3,
                          "encoder_train_bwd_blocked_calls": 1, "encoder_train_bwd_blocks": 3}
        assert seen == [("fwd", not env)] * 3 + [("bwd", not env)] * 3
    assert all(torch.equal(out[""][k], out["1"][k]) for k in out[""])
