"""Blocks of whole bags chosen from shapes, and the per-op lane in blocks and
under cfg.remat, on the CPU (the plain versions of rows 4-5 and 15-20):
K6/K7's blocks read the card's total memory, never its free memory
(`encoder_train.device_total_bytes`); `models/abmil.py::abmil_embed_train`
in forced blocks against one block (pooled and tokens bit for bit, the
gradients within 1e-5 of their largest entry), bf16 and f32, sigmoid and
softmax, n_views 1 and 3; the per-op block rule at the published widths;
a per-op train step under cfg.remat against the same step without it (the
loss and every gradient bit for bit, and the forward's saved bytes with
remat at most the stain inputs plus one stain's share); the fused lane not
wrapped. Port against port: the unblocked lane is held against JAX's
interpret-mode ops in tests/test_torch_perop_train.py and
tests/test_torch_perop_f32.py."""

import types

import numpy as np
import pytest
import torch

from madeleine_torch.config import MadeleineConfig
from madeleine_torch.models import abmil
from madeleine_torch.models import madeleine as port
from madeleine_torch.models.madeleine import MADELEINE, init_madeleine, train_weights
from madeleine_torch.ops import encoder_train as et
from madeleine_torch.train.optim import make_optimizer
from madeleine_torch.train.trainer import make_train_step
from tests.torch_port_helpers import SMALL, ragged_mask

B, T = 5, 40
LENGTHS = [40, 17, 0, 40, 33]   # bag 2 empty
SEED = 11
# the published widths: d_in, hidden, heads, head width, gate width, d_out
WIDTHS = (512, 512, 4, 512, 512, 128)


def _model(**cfg):
    c = MadeleineConfig(**dict(SMALL, **cfg)).finalize()
    return init_madeleine(MADELEINE(c), torch.Generator().manual_seed(3))


def _bags(dtype, d=64):
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(B, T, d, generator=gen) * torch.from_numpy(ragged_mask(LENGTHS, T))[..., None]
    return x.to(dtype), torch.from_numpy(ragged_mask(LENGTHS, T))


def test_encoder_train_blocks_read_the_total_memory_not_the_free(monkeypatch):
    """`device_total_bytes` on a card reads its properties and never
    mem_get_info; `encoder_train`'s default call takes the blocks
    `encoder_blocks(..., limit=<total>)` gives, whatever memory the save
    gate's guard sees left (a tighter one changes nothing)."""
    def no_free_memory(*_, **__):
        raise AssertionError("the block rule read the free memory")

    monkeypatch.setattr(torch.cuda, "mem_get_info", no_free_memory)
    props = types.SimpleNamespace(total_memory=85_000_000_000)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: props)
    assert et.device_total_bytes(torch.device("cuda", 0)) == props.total_memory
    assert et.device_total_bytes("cpu") is None

    model = _model()
    w = {k: v.detach() for k, v in train_weights(model, torch.float32).items()}
    x, mask = _bags(torch.float32)
    widths = (64, 128, 2, 128, 64, 128)
    per_bag = T * et._block_row_bytes(widths, 4, False)
    total = et.BLOCK_MARGIN + 2 * per_bag        # room for blocks of two bags
    want = et.encoder_blocks(B, T, widths, torch.float32, False, limit=total)
    assert want == [(0, 2), (2, 4), (4, 5)]
    monkeypatch.setattr(et, "device_total_bytes", lambda device=None: total)
    for left in (None, et.GUARD_MARGIN + 10 * per_bag, 0):   # what the save gate sees free
        monkeypatch.setattr(et, "_device_hbm_limit", lambda device=None, left=left: left)
        before = (et.fwd_blocked_calls, et.fwd_blocks)
        et.encoder_train(x, mask, w, SEED, save_acts=True)
        assert (et.fwd_blocked_calls - before[0], et.fwd_blocks - before[1]) == (1, len(want))
    # the per-op lane reads the same limit
    monkeypatch.setattr(abmil, "PEROP_BLOCK_BUDGET_BYTES", 10 ** 15)
    per_bag = T * abmil.perop_row_bytes(widths, 4, "sigmoid")
    monkeypatch.setattr(et, "device_total_bytes",
                        lambda device=None: et.BLOCK_MARGIN + 3 * per_bag)
    before = (abmil.perop_blocked_calls, abmil.perop_blocks)
    abmil.abmil_embed_train(w, x, activation="sigmoid", seed=SEED, mask=mask,
                            project=lambda y: port.project_tokens(y, w["wt"], w["bt"]))
    assert (abmil.perop_blocked_calls - before[0], abmil.perop_blocks - before[1]) == (1, 2)


def _grads(dtype, activation, n_views, block_bags):
    """pooled, tokens and the gradients of a fixed loss of one
    `abmil_embed_train` call (the token projector inside each block)."""
    model = _model()
    w = {k: v.detach().requires_grad_() for k, v in train_weights(model, dtype).items()}
    x, mask = _bags(dtype)
    x.requires_grad_()
    half = torch.from_numpy(np.random.default_rng(2).permutation(T) < T // 2)
    pooled, tok = abmil.abmil_embed_train(
        w, x, activation=activation, seed=SEED, mask=mask, row_offset=7,
        half_mask=half if n_views == 3 else None, block_bags=block_bags,
        project=lambda y: port.project_tokens(y, w["wt"], w["bt"]))
    loss = torch.sin(pooled.float()).sum() + (torch.cos(tok.float()) * 0.01).sum()
    loss.backward()
    return pooled.detach(), tok.detach(), {**{k: v.grad for k, v in w.items()}, "x": x.grad}


def _bf16_step(v: float) -> float:
    """One bf16 rounding step (ulp) at magnitude v."""
    return 2.0 ** (np.floor(np.log2(v)) - 7) if v > 0 else 0.0


@pytest.mark.parametrize("n_views", [1, 3])
@pytest.mark.parametrize("activation", ["sigmoid", "softmax"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_blocked_perop_call_matches_one_block(dtype, activation, n_views):
    """Blocks of 2 bags (0-2, 2-4, 4-5; the empty bag inside one) against
    the whole call as one block at the real dropout rates: each block runs
    the chain at row offset row_offset + b0, so the projected tokens are the
    one block's bit for bit, and so is pooled where the pool is rows 4-5's
    (softmax: each bag pooled alone). The plain pool of another activation
    is PyTorch's einsum, whose CPU product sums a one-bag block in another
    order: pooled there within 1e-5 of its largest entry. The gradients
    (autograd's sums over the blocks) and dx within 1e-5 of their largest
    entry in f32, bc (an exact 0 under softmax: rounding noise) within 1e-5;
    in bf16 the weight gradients are bf16 tensors, summed over the blocks by
    autograd in bf16 as over the stains: within two bf16 steps of their
    largest entry. The blocked call is counted."""
    before = (abmil.perop_blocked_calls, abmil.perop_blocks)
    p2, t2, g2 = _grads(dtype, activation, n_views, 2)
    assert (abmil.perop_blocked_calls - before[0], abmil.perop_blocks - before[1]) == (1, 3)
    p1, t1, g1 = _grads(dtype, activation, n_views, B)
    assert (abmil.perop_blocked_calls - before[0]) == 1
    assert torch.equal(t2, t1)
    if activation == "softmax":
        assert torch.equal(p2, p1)
    else:
        err = float((p2.float() - p1.float()).abs().max())
        assert err <= 1e-5 * float(p1.float().abs().max()), err
    for k, g in g1.items():
        scale = float(g.float().abs().max())
        err = float((g2[k].float() - g.float()).abs().max())
        if dtype == torch.bfloat16:
            bar = 2 * _bf16_step(scale)
        else:
            bar = 1e-5 if (k == "bc" and activation == "softmax") else 1e-5 * scale
        assert err <= bar, (k, err, scale)


def _rule_cases():
    return {
        # the steps at 2048 tokens and the f32 CLI at bucket 8192: one block
        "step_bf16_softmax": (65, 2048, torch.bfloat16, "softmax", 1, 1),
        "step_f32_sigmoid": (65, 2048, torch.float32, "sigmoid", 1, 1),
        "views_bf16_softmax": (65, 2048, torch.bfloat16, "softmax", 3, 1),
        "cli_8192_f32_sigmoid": (65, 8192, torch.float32, "sigmoid", 1, 1),
        # the grown shapes: two blocks of 33 and 32 bags
        "ragged_16384_f32_sigmoid": (65, 16384, torch.float32, "sigmoid", 1, 2),
        "grown_32768_bf16_softmax": (65, 32768, torch.bfloat16, "softmax", 1, 2),
        # rows 4-5's grid takes at most 65535 bags a call
        "many_bags": (70000, 16, torch.bfloat16, "softmax", 1, 2),
    }


@pytest.mark.parametrize("case", list(_rule_cases()))
def test_perop_block_rule(case):
    """The per-op rule at the published widths on an 80 GB card: contiguous
    blocks covering [0, b) within one bag of each other, each under the
    budget (`perop_row_bytes` times its rows), the rows and bags limits;
    the smoke run's calls at 2048 and 8192 one block."""
    b, t, dtype, activation, n_views, n_blocks = _rule_cases()[case]
    blocks = abmil.perop_blocks_of(b, t, WIDTHS, dtype, activation, n_views,
                                   limit=80 * 1024 ** 3)
    assert len(blocks) == n_blocks
    assert blocks[0][0] == 0 and blocks[-1][1] == b
    assert all(p[1] == q[0] for p, q in zip(blocks, blocks[1:]))
    sizes = [b1 - b0 for b0, b1 in blocks]
    assert max(sizes) - min(sizes) <= 1 and max(sizes) <= et.MAX_POOL_BAGS
    row = abmil.perop_row_bytes(WIDTHS, torch.empty((), dtype=dtype).element_size(),
                                activation, n_views)
    assert max(sizes) * t * row <= abmil.PEROP_BLOCK_BUDGET_BYTES
    assert max(sizes) * t <= et.MAX_BLOCK_ROWS[dtype]
    with pytest.raises(MemoryError, match="one bag"):
        abmil.perop_blocks_of(2, 2 ** 21, WIDTHS, dtype, activation, n_views)


def _step(remat, activation="sigmoid", hooks=None):
    """One f32 train step (InfoNCE, rates as the ops read them) on a ragged
    batch: (loss, {name: gradient}, the parameters after the update), and
    with `hooks` the bytes the step's forward saved for its backward
    outside a checkpoint (each storage once)."""
    model = _model(activation=activation, remat=remat, local_loss="-1", temperature=0.1,
                   warmup=False, max_epochs=2)
    opt, sched = make_optimizer(model.cfg, model.parameters(), steps_per_epoch=4)
    step = make_train_step(model.cfg, model, opt, sched)
    gen = torch.Generator().manual_seed(9)
    lengths = np.array([[24, 11, 0], [24, 24, 5], [3, 24, 24], [24, 9, 17]])
    mask = np.arange(24)[None, None, :] < lengths[..., None]
    batch = {"feats": torch.randn(4, 3, 24, 64, generator=gen) * torch.from_numpy(mask)[..., None],
             "modality_labels": torch.from_numpy((lengths > 0).astype(np.float32)),
             "sample_mask": torch.ones(4, dtype=torch.bool), "token_mask": mask}
    _, metrics = step(batch, SEED)
    assert not bool(metrics["skipped"])
    grads = {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}
    params = {k: v.clone() for k, v in model.state_dict().items()}
    saved = None
    if hooks:
        seen = {}

        def pack(x):
            seen[x.untyped_storage().data_ptr()] = x.untyped_storage().nbytes()
            return x

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
            port.forward_train(model, batch["feats"], mask=torch.from_numpy(mask), seed=SEED)
        saved = sum(seen.values())
    return float(metrics["loss"]), grads, params, saved, batch


def test_remat_step_equals_the_step_without_it():
    """cfg.remat on the per-op lane (sigmoid): each modality's body under a
    checkpoint, recomputed in its backward from the same Philox keys; the
    loss, every gradient and the updated parameters equal the step without
    remat bit for bit. The forward's saved bytes outside a checkpoint
    (saved_tensors_hooks) are at most the stain inputs plus one stain's
    share of what the step without remat saves."""
    loss_r, g_r, p_r, saved_r, batch = _step(True, hooks=True)
    loss_n, g_n, p_n, saved_n, _ = _step(False, hooks=True)
    assert loss_r == loss_n
    assert all(torch.equal(g_r[k], g_n[k]) for k in g_n)
    assert all(torch.equal(p_r[k], p_n[k]) for k in p_n)
    n_mod = batch["feats"].shape[1]
    assert saved_r <= batch["feats"].nbytes + saved_n / n_mod, (saved_r, saved_n)
    assert saved_n > 2 * saved_r


def test_the_fused_lane_is_not_wrapped(monkeypatch):
    """With softmax on the fused lane cfg.remat changes nothing: no
    checkpoint, K6/K7's plain versions called once per modality each way,
    as without remat."""
    calls = []
    fwd, bwd = et.encoder_train_fwd_plain, et.encoder_train_bwd_plain
    monkeypatch.setattr(et, "encoder_train_fwd_plain",
                        lambda *a, **k: calls.append("fwd") or fwd(*a, **k))
    monkeypatch.setattr(et, "encoder_train_bwd_plain",
                        lambda *a, **k: calls.append("bwd") or bwd(*a, **k))

    def no_checkpoint(*_, **__):
        raise AssertionError("the fused lane ran under a checkpoint")

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", no_checkpoint)
    counts = {}
    for remat in (True, False):
        calls.clear()
        _step(remat, activation="softmax")
        counts[remat] = (calls.count("fwd"), calls.count("bwd"))
    assert counts[True] == counts[False] == (3, 3)
