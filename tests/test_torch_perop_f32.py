"""Rows 15-18 with f32 operands (the per-op lane at `--precision float32`),
checked on the CPU: a plain mirror of the f32 kernels' sum orders against the
JAX package's interpret-mode f32 ops (`preattn._fwd_call` / `_bwd_call`,
`gated_logits._fwd_call` / `_bwd_call`) at rate 0 on a ragged M; the
wrappers' refusal of mixed bf16 / f32 operand sets; the f32 token projector
against JAX's `_linear` at HIGHEST; and an f32 sigmoid train step through
`TrainStep`, run in the kernels' orders, against the JAX package's step.

The orders mirrored (csrc/preattn.cu, csrc/gated_logits.cu on
csrc/train_rows.cuh and csrc/gemm_ffma.cuh): each LayerNorm row's
statistics as `ln_gelu_fwd` sums them (a thread's four columns in order,
each warp's xor butterfly, the warps in order); the gate logits' 64-column
partials as fixed xor trees of 16 four-column sums added in chunk order;
the weight gradients' token sums in pieces added in piece order. The
column partials of the bias and LN gradients are not mirrored. The kernels
themselves are held against their plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madeleine_tpu.models import abmil as jax_abmil
from madeleine_tpu.models import madeleine as mtm
from madeleine_torch.config import MadeleineConfig
from madeleine_torch.models import madeleine as port
from madeleine_torch.models.madeleine import train_weights
from madeleine_torch.ops import gated_logits as gl
from madeleine_torch.ops import linear_tok as lt
from madeleine_torch.ops import preattn as pa
from madeleine_torch.ops import prng
from madeleine_torch.train.optim import make_optimizer
from madeleine_torch.train.trainer import make_train_step
from tests.test_torch_encoder_train_f32 import _piece_sum, _tree_logits
from tests.test_torch_train import STEP_CFG, _jax_run
from tests.torch_port_helpers import grads_as_state_dict, param_pair, to_torch, train_batch

B, T, D_IN, HID, NH, F = 3, 100, 64, 128, 2, 128   # M = 300: a partial last 64-row tile
T_BLOCK = 32                                      # JAX's last 32-token block is partial
SEED = 13
LANES = 32


@pytest.fixture(scope="module")
def setup():
    """JAX params and the port's f32 operands at narrow widths (hidden 128,
    2 heads, gate width 128: E = 256, two 64-column logit chunks a head),
    x [3, 100, 64], a cotangent dy [3, 100, 256], y and dl."""
    _, _, params, model = param_pair(seed=3, patch_embedding_dim=D_IN,
                                     wsi_encoder_hidden_dim=HID, n_heads=NH,
                                     attention_hidden_dim=F)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, T, D_IN)).astype(np.float32)
    dy = rng.standard_normal((B, T, NH * HID)).astype(np.float32)
    y = rng.standard_normal((B, T, NH * HID)).astype(np.float32)
    dl = rng.standard_normal((B, T, NH)).astype(np.float32)
    w = {k: v.detach() for k, v in train_weights(model, torch.float32).items()}
    return params, w, x, dy, y, dl


def _block_sum(v):
    """train_common.cuh::group_sum over a row's threads (last axis, a
    multiple of 32): each warp's xor butterfly (16, 8, 4, 2, 1), then the
    warps' sums in warp order."""
    lane = torch.arange(LANES)
    q = v.reshape(*v.shape[:-1], -1, LANES)
    for o in (16, 8, 4, 2, 1):
        q = q + q[..., lane ^ o]
    q = q[..., 0]
    s = q[..., 0]
    for i in range(1, q.shape[-1]):
        s = s + q[..., i]
    return s


def _rows_mirror(z, s, sh, keep):
    """One layer of train_rows.cuh::ln_gelu_fwd<float> on z [M, W] (bias
    included): thread c holds columns 4c .. 4c + 3. Returns (u, rstd [M],
    h)."""
    m, width = z.shape
    zz = z.reshape(m, width // 4, 4)
    mean = _block_sum(((zz[..., 0] + zz[..., 1]) + zz[..., 2]) + zz[..., 3]) / width
    d = zz - mean[:, None, None]
    dev = (((d[..., 0] * d[..., 0]) + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]) \
        + d[..., 3] * d[..., 3]
    rstd = torch.rsqrt(_block_sum(dev) / width + pa.LN_EPS)
    u = (z - mean[:, None]) * rstd[:, None]
    v = u * s + sh
    return u, rstd, v * pa.cdf(v) * keep


def _stack_mirror(x, w, seed, rows, toks, rate):
    """`pa.stack_fwd_plain` as kernels 15 and 16 run it in f32: each
    layer's product plus bias, then `_rows_mirror`; nothing rounded."""
    b, t, _ = x.shape
    h, hs, us, rstds = x.reshape(b * t, -1), [], [], []
    for i in (1, 2, 3):
        z = pa.mm(h, w[f"w{i}"]) + w[f"b{i}"]
        keep = prng.keep_mask(seed, rows, toks, i - 1, z.shape[-1], rate).reshape(b * t, -1)
        u, rstd, h = _rows_mirror(z, w[f"s{i}"], w[f"t{i}"], keep)
        us.append(u.reshape(b, t, -1))
        rstds.append(rstd.reshape(b, t, 1))
        hs.append(h.reshape(b, t, -1))
    return hs[0], hs[1], hs[2], us, torch.cat(rstds, dim=-1)


@pytest.fixture
def kernel_orders(monkeypatch):
    """The plain versions of rows 15-18 (and the train step's per-op lane
    on the CPU) in the f32 kernels' orders."""
    def use(chunk=None):
        monkeypatch.setattr(pa, "stack_fwd_plain", _stack_mirror)
        monkeypatch.setattr(pa, "token_sum", _piece_sum(chunk))
        monkeypatch.setattr(gl, "logits_plain", _tree_logits)
    return use


def _assert_grads(got, want):
    """rtol 1e-4, atol 1e-5 x the reference's largest entry (at least 1)."""
    for k, ref in want.items():
        ref = np.asarray(ref)
        np.testing.assert_allclose(np.asarray(got[k]), ref, rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(np.abs(ref).max())), err_msg=k)


@pytest.mark.parametrize("chunk", [None, 48], ids=["kernel_pieces", "7_pieces"])
def test_rows_15_16_f32_mirror_matches_jax_interpret(setup, kernel_orders, chunk):
    """Row 15's mirror against JAX's interpret-mode f32 `_fwd_call` (y at
    rtol 1e-4 / atol 1e-5) and row 16's (the recompute in the mirror's
    order, the adjoint's weight gradients in token pieces: the kernel's own
    length, one piece at this size, or 48 tokens, seven pieces) against
    `_bwd_call`: dx and the 12 gradients at rtol 1e-4, atol 1e-5 x their
    largest entry."""
    from madeleine_tpu.ops.preattn import _bwd_call, _fwd_call, _weight_args

    params, w, x, dy, _, _ = setup
    kernel_orders(chunk)
    wargs = _weight_args(jax.tree_util.tree_map(jnp.asarray,
                                                params["wsi_embedders"]["pre_attn"]),
                         jnp.float32)
    y_j = _fwd_call(jnp.asarray(x), jnp.int32(SEED), *wargs, rate=0.0, t_block=T_BLOCK,
                    interpret=True)
    dx_j, g_j = _bwd_call(jnp.asarray(x), jnp.asarray(dy), jnp.int32(SEED), *wargs, rate=0.0,
                          t_block=T_BLOCK, interpret=True)
    xt = to_torch(x)
    np.testing.assert_allclose(pa.preattn_fwd_plain(xt, w, SEED, 0, 0.0).numpy(),
                               np.asarray(y_j), rtol=1e-4, atol=1e-5)
    got = pa.preattn_bwd_plain(xt, to_torch(dy), w, SEED, 0, 0.0, need_dx=True)
    want = {"x": dx_j}
    for k, g in zip(pa.KEYS, g_j):
        want[k] = np.asarray(g).T if k in pa.MATS else g   # JAX's [in, out] layout
    _assert_grads({k: v.numpy() for k, v in got.items()}, want)


def _jax_attn(params):
    attn = params["wsi_embedders"]["attn"]
    nh, e, f = attn["wa"].shape
    args = [jnp.asarray(attn[k], jnp.float32) for k in ("wa", "ba", "wb", "bb")]
    args += [jnp.asarray(attn["wc"], jnp.float32).reshape(nh, f),
             jnp.asarray(attn["bc"], jnp.float32).reshape(nh, 1)]
    return args, dict(e=e, nh=nh, f=f, rate=0.0, t_block=T_BLOCK, interpret=True)


@pytest.mark.parametrize("chunk", [None, 48], ids=["kernel_pieces", "7_pieces"])
def test_rows_17_18_f32_mirror_matches_jax_interpret(setup, kernel_orders, chunk):
    """Row 17's mirror (the gate logits' xor trees per 64-column chunk,
    added in chunk order) against JAX's interpret-mode f32 `_fwd_call` at
    rtol 1e-4 / atol 1e-5, and row 18's (the gates recomputed in f32, DZG
    unrounded, dWa and dWb in token pieces) against `_bwd_call`: dy and the
    five gradients at rtol 1e-4, atol 1e-5 x their largest entry."""
    from madeleine_tpu.ops.gated_logits import _bwd_call, _fwd_call

    params, w, _, _, y, dl = setup
    kernel_orders(chunk)
    args, kw = _jax_attn(params)
    l_j = _fwd_call(jnp.asarray(y), jnp.int32(SEED), *args, **kw)
    dy_j, dwa, dba, dwb, dbb, dwc = _bwd_call(jnp.asarray(y), jnp.asarray(dl), jnp.int32(SEED),
                                              *args, **kw)
    yt = to_torch(y)
    np.testing.assert_allclose(gl.gated_logits_fwd_plain(yt, w, SEED, 0, 0.0).numpy(),
                               np.asarray(l_j), rtol=1e-4, atol=1e-5)
    got = gl.gated_logits_bwd_plain(yt, to_torch(dl), w, SEED, 0, 0.0)
    assert got["y"].dtype == torch.float32
    _assert_grads({k: v.numpy() for k, v in got.items()},
                  {"y": dy_j, "wa": np.swapaxes(np.asarray(dwa), 1, 2), "ba": dba,
                   "wb": np.swapaxes(np.asarray(dwb), 1, 2), "bb": dbb, "wc": dwc})


PREATTN_MIXED = [(torch.bfloat16, {}, "w1"),                     # bf16 x, f32 weights
                 (torch.float32, {"w2": torch.bfloat16}, "w2"),  # f32 x, one bf16 matrix
                 (torch.float32, {"s1": torch.bfloat16}, "s1"),  # a vector that is not f32
                 (torch.float16, {}, "x")]
GATES_MIXED = [(torch.bfloat16, {}, "wa"), (torch.float32, {"wb": torch.bfloat16}, "wb"),
               (torch.float32, {"bc": torch.bfloat16}, "bc"), (torch.float16, {}, "y")]


@pytest.mark.parametrize("case", range(4))
def test_wrappers_refuse_a_mixed_operand_set(setup, case):
    """Rows 15-18's dtype checks (`check_dtypes`, which every wrapper runs
    on a CUDA tensor before it launches) refuse an operand set whose
    matrices are not all in the input's dtype (bf16 or f32), or whose
    vectors are not f32, with a ValueError naming the operand; an all-f32
    set and an all-bf16 one pass and give their dtype. On the CPU the
    wrappers refuse before any check of dtype. The first designs take bf16
    only."""
    _, w, x, _, y, _ = setup
    x_dt, mixed, name = PREATTN_MIXED[case]
    wp = dict(w, **{k: w[k].to(dt) for k, dt in mixed.items()})
    for kernel in ("preattn_fwd", "preattn_bwd"):
        with pytest.raises(ValueError, match=rf"{kernel} kernel: {name} .*(mixed|bf16 or f32)"):
            pa.check_dtypes(to_torch(x).to(x_dt), wp, kernel)
    y_dt, mixed, name = GATES_MIXED[case]
    wg = dict(w, **{k: w[k].to(dt) for k, dt in mixed.items()})
    for kernel in ("gated_logits_fwd", "gated_logits_bwd"):
        with pytest.raises(ValueError, match=rf"{kernel} kernel: {name} .*(mixed|bf16 or f32)"):
            gl.check_dtypes(to_torch(y).to(y_dt), wg, kernel)
    bf = {k: v.to(torch.bfloat16) if k in pa.MATS + gl.MATS else v for k, v in w.items()}
    for dt, ops in ((torch.float32, w), (torch.bfloat16, bf)):
        assert pa.check_dtypes(to_torch(x).to(dt), ops, "k") == dt
        assert gl.check_dtypes(to_torch(y).to(dt), ops, "k") == dt
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            pa.preattn_fwd_cuda(to_torch(x).to(dt), ops, SEED)
    with pytest.raises(ValueError, match="bf16 only"):
        pa.entry_of({torch.bfloat16: "preattn_forward_rowblock"}, torch.float32,
                    "preattn_fwd_rowblock")


def test_f32_token_projector_is_jax_linear_at_highest(setup, monkeypatch):
    """`project_tokens` on f32 tokens is a plain product (never the bf16
    train op of rows 19/20) equal to JAX's `_linear` at HIGHEST (rtol 1e-5,
    atol 1e-6) with its gradients equal to autograd's of the same product;
    bf16 tokens take the train op."""
    _, w, _, _, y, _ = setup
    wt, bt = w["wt"], w["bt"]
    want = mtm._linear({"w": jnp.asarray(wt.numpy().T), "b": jnp.asarray(bt.numpy())},
                       jnp.asarray(y))
    calls = []
    monkeypatch.setattr(port, "linear_tok_train",
                        lambda *a: calls.append(a[0].dtype) or lt.linear_tok_train(*a))
    yt = to_torch(y).requires_grad_(True)
    tok = port.project_tokens(yt, wt, bt)
    np.testing.assert_allclose(tok.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    tok.square().sum().backward()
    torch.testing.assert_close(yt.grad, 2 * tok.detach() @ wt, rtol=1e-5, atol=1e-5)
    assert calls == []
    port.project_tokens(yt.detach().bfloat16(), wt.bfloat16(), bt)
    assert calls == [torch.bfloat16]


@pytest.fixture
def rates_zero(monkeypatch):
    """Both packages' per-op dropout rates set to 0 (each reads them at call
    or trace time)."""
    monkeypatch.setattr(jax_abmil, "PRE_ATTN_DROPOUT", 0.0)
    monkeypatch.setattr(jax_abmil, "ATTN_DROPOUT", 0.0)
    monkeypatch.setattr(pa, "RATE", 0.0)
    monkeypatch.setattr(gl, "RATE", 0.0)


def test_f32_sigmoid_train_step_in_kernel_orders_matches_jax(rates_zero, kernel_orders):
    """One f32 InfoNCE step with the sigmoid activation through `TrainStep`
    on the CPU, its rows 15-18 in the f32 kernels' orders (token pieces of
    8 tokens), against the JAX package's step on its per-op route at rates
    0: the loss at rtol 1e-4 (temperature 0.001), each gradient at 1e-4
    relative Frobenius (the token projector's is 0, or none, on both sides:
    InfoNCE does not read the tokens), the step applied."""
    kernel_orders(8)
    jcfg, pcfg, params, model = param_pair(seed=12, activation="sigmoid", **STEP_CFG)
    batch = train_batch(np.random.default_rng(13), bs=4, n_mod=3, t=16, d=64)
    want_losses, jgrads, _ = _jax_run(jcfg, params, batch, 1)
    want_grads = grads_as_state_dict(jgrads, params)
    model.train()
    opt, sched = make_optimizer(pcfg, model.parameters(), steps_per_epoch=10)
    step = make_train_step(pcfg, model, opt, sched)
    assert step.dtype == torch.float32
    _, metrics = step(batch, seed=0)
    assert not bool(metrics["skipped"])
    np.testing.assert_allclose(float(metrics["loss"]), want_losses[0], rtol=1e-4)
    for k, p in model.named_parameters():
        ref = want_grads[k]
        if float(ref.norm()) == 0.0:
            assert p.grad is None or float(p.grad.abs().max()) == 0.0, k
        else:
            assert float((p.grad - ref).norm() / ref.norm()) < 1e-4, k
