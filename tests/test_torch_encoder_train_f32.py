"""K6 / K7 with f32 operands (the JAX package's parity route, `--precision
float32`), checked on the CPU: the residual buffers' bytes against the
save/recompute gate's reckoning, the operand checks' refusal of mixed bf16 /
f32 sets, the train step's route for an f32 step on the card, and a
plain mirror of the f32 kernels' sum orders (the gate logits' 64-column
partials each a fixed tree of 16 four-column sums, csrc/gemm_ffma.cuh::
epilogue_gates; the weight gradients' token sums in pieces added in piece
order, gemm_ffma.cuh::wgrad) against the JAX package's interpret-mode
`encoder_train` in f32. The kernels themselves are held against their plain
versions on the card (tests/test_torch_gpu.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madeleine_torch.config import MadeleineConfig
from madeleine_torch.models.madeleine import fused_route, train_weights
from madeleine_torch.ops import encoder_train as et
from madeleine_torch.ops import gated_logits as gl
from madeleine_torch.ops import preattn as pa
from tests.torch_port_helpers import grads_as_state_dict, param_pair, to_torch

B, T, D, NH, E = 2, 96, 128, 2, 128   # f = E = 128: two 64-column logit chunks per head
T_BLOCK = 32
SEED = 7


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,t,hd,nh,e,f", [(65, 2048, 512, 4, 512, 512), (3, 300, 128, 2, 128, 128)])
def test_saved_buffers_are_the_bytes_the_gate_reckons(dtype, b, t, hd, nh, e, f, monkeypatch):
    """`_saved_buffers` in the call's dtype holds exactly the bytes that
    `resolve_save_acts` reckons at its itemsize (4 in f32, 2 in bf16): a
    budget of those bytes takes the save route, one byte less the recompute
    route."""
    E_ = nh * e
    bufs = et._saved_buffers(b, t, hd, E_, nh * f, "meta", dtype)
    assert set(bufs) == set(et.SAVED)
    assert all(v.dtype == (torch.float32 if k == "rstd" else dtype) for k, v in bufs.items())
    nbytes = sum(v.numel() * v.element_size() for v in bufs.values())
    itemsize = torch.empty((), dtype=dtype).element_size()
    assert nbytes == b * t * ((2 * hd + E_ + 2 * nh * f) * itemsize + 12)
    monkeypatch.delenv(et.NO_SAVE_VAR, raising=False)
    for budget, route in ((nbytes, True), (nbytes - 1, False)):
        monkeypatch.setattr(et, "ACT_BUDGET_BYTES", budget)
        assert et.resolve_save_acts(None, b, t, hd, E_, 2 * nh * f, itemsize,
                                    device="cpu") is route


@pytest.fixture(scope="module")
def setup():
    jcfg, pcfg, params, model = param_pair(seed=1, patch_embedding_dim=D,
                                           wsi_encoder_hidden_dim=E, n_heads=NH,
                                           attention_hidden_dim=E)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    mask = rng.random((B, T)) < 0.8
    return params, model, x, mask


def _operands(model, dtype):
    return {k: v.detach().contiguous() for k, v in train_weights(model, dtype).items()}


@pytest.mark.parametrize("x_dtype,mixed,name", [
    (torch.bfloat16, {}, "w1"),                      # bf16 x, f32 weights
    (torch.float32, {"wt": torch.bfloat16}, "wt"),   # f32 x, one bf16 matrix
    (torch.float32, {"ba": torch.bfloat16}, "ba"),   # a vector that is not f32
    (torch.float16, {}, "x"),
], ids=["bf16_x_f32_w", "f32_x_bf16_wt", "bf16_vector", "f16_x"])
def test_operand_checks_refuse_a_mixed_set(setup, x_dtype, mixed, name):
    """K6's and K7's wrappers refuse an operand set whose matrices are not
    all in x's dtype (bf16 or f32), or whose vectors are not f32, with a
    ValueError naming the operand, before they look at the device; an
    all-f32 set passes them and is then refused only for lying on the CPU."""
    _, model, x, _ = setup
    w = _operands(model, torch.float32)
    w.update({k: w[k].to(dt) for k, dt in mixed.items()})
    xt = to_torch(x).to(x_dtype)
    bias = et.token_mask_bias(None, B, T, "cpu")
    with pytest.raises(ValueError, match=rf"\b{name}\b"):
        et.encoder_train_fwd_cuda(xt, bias, w, SEED)
    with pytest.raises(ValueError, match=rf"\b{name}\b"):
        et.check_dtypes(xt, w, "encoder_train_bwd")
    assert et.check_dtypes(to_torch(x), _operands(model, torch.float32), "k") == torch.float32
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        et.encoder_train_fwd_cuda(to_torch(x), bias, _operands(model, torch.float32), SEED)


@pytest.mark.parametrize("precision,activation,no_fused,per_op", [
    ("float32", "softmax", "", False),     # the fused route: K6/K7 in f32
    ("bfloat16", "softmax", "", False),
    ("float32", "sigmoid", "", True),      # the per-op lane: rows 15-18 in f32
    ("float32", "softmax", "1", True),     # softmax under MADELEINE_NO_FUSED_ENCODER
    ("bfloat16", "sigmoid", "", True),
])
def test_card_route_of_an_f32_step(setup, precision, activation, no_fused, per_op,
                                   monkeypatch):
    """The route a train step takes on the card, for both precisions: the
    fused route (K6/K7, bf16 or f32 operands) for softmax, else the per-op
    lane, whose rows 15-18 now take the step's dtype too: the wrappers'
    dtype check accepts an all-f32 and an all-bf16 operand set alike (and
    the call is then refused only for lying on the CPU), so no step is
    refused for its precision."""
    _, model, x, _ = setup
    monkeypatch.setenv("MADELEINE_NO_FUSED_ENCODER", no_fused)
    cfg = MadeleineConfig(precision=precision, activation=activation).finalize()
    dtype = torch.float32 if precision == "float32" else torch.bfloat16
    assert fused_route(cfg) is not per_op
    w = _operands(model, dtype)
    xt = to_torch(x).to(dtype)
    assert pa.check_dtypes(xt, w, "preattn_fwd") == dtype
    y = torch.zeros(B, T, w["wa"].shape[0] * w["wa"].shape[2], dtype=dtype)
    assert gl.check_dtypes(y, w, "gated_logits_fwd") == dtype
    for call, args in ((pa.preattn_fwd_cuda, (xt, w, SEED)),
                       (gl.gated_logits_fwd_cuda, (y, w, SEED))):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            call(*args)


# ---------------------------------------------------------------------------
# the f32 kernels' sum orders, mirrored, against JAX
# ---------------------------------------------------------------------------

def _loss_jax(pooled, tok):
    return jnp.sum(jnp.sin(pooled)) + jnp.sum(jnp.cos(tok) * 0.01)


def _loss_torch(pooled, tok):
    return torch.sin(pooled).sum() + (torch.cos(tok) * 0.01).sum()


@pytest.fixture(scope="module")
def jax_ref(setup):
    """JAX's interpret-mode f32 `encoder_train` on the ragged batch at rate
    0: pooled, tokens and every gradient, computed once for every case."""
    from madeleine_tpu.ops.encoder_train import encoder_train

    params, _, x, mask = setup

    def f(pre, attn, tokp):
        p, tk = encoder_train(jnp.asarray(x), pre, attn, tokp, jnp.asarray(mask),
                              jnp.int32(SEED), 0.0, 0.0, T_BLOCK, False, True)
        return _loss_jax(p, tk), (p, tk)

    emb = params["wsi_embedders"]
    (_, (p, tk)), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        emb["pre_attn"], emb["attn"], params["token_projector"])
    gsd = grads_as_state_dict({"wsi_embedders": {"pre_attn": grads[0], "attn": grads[1]},
                               "token_projector": grads[2]}, params)
    return np.asarray(p), np.asarray(tk), gsd


def _logit_tree(terms):
    """The f32 gate epilogue's sum over a 64-column chunk [..., 64]: each
    thread's four columns in order, then the 16 threads in xor steps 1, 2,
    4, 8 (csrc/gemm_ffma.cuh::epilogue_gates)."""
    q = terms.reshape(*terms.shape[:-1], 16, 4)
    part = ((q[..., 0] + q[..., 1]) + q[..., 2]) + q[..., 3]
    while part.shape[-1] > 1:
        part = part[..., 0::2] + part[..., 1::2]
    return part[..., 0]


def _tree_logits(a_pre, b_pre, ma, mb, w):
    """`gl.logits_plain` in the f32 gate epilogue's order: per 64-column
    chunk `_logit_tree`, the chunks added in chunk order, then bc."""
    terms = (a_pre * ma) * (b_pre * mb) * w["wc"]
    parts = _logit_tree(terms.reshape(*terms.shape[:-1], -1, et.GATE_CHUNK))
    l = parts[..., 0]
    for c in range(1, parts.shape[-1]):
        l = l + parts[..., c]
    return l + w["bc"]


def _piece_sum(chunk):
    """`pa.token_sum` in the f32 weight gradients' order: the tokens cut into
    pieces of `chunk` (None: the kernel's `ffma_wgrad_chunk` for the shape),
    each piece's product, the pieces added in order."""
    def token_sum(a, b):
        a2 = pa.wide(a).reshape(-1, a.shape[-1])
        b2 = pa.wide(b).reshape(-1, b.shape[-1])
        n = a2.shape[0]
        c = et.ffma_wgrad_chunk(a2.shape[1], b2.shape[1], n, 1) if chunk is None else chunk
        out = a2[:c].T @ b2[:c]
        for s in range(c, n, c):
            out = out + a2[s:s + c].T @ b2[s:s + c]
        return out
    return token_sum


@pytest.mark.parametrize("chunk", [None, 16, 48], ids=["kernel", "12_pieces", "4_pieces"])
def test_f32_kernel_order_mirror_matches_jax(setup, jax_ref, chunk, monkeypatch):
    """The plain op with the f32 kernels' sum orders (the gate logits' xor
    tree per 64-column chunk, the weight gradients' token pieces) against
    JAX's interpret-mode f32 op at rate 0 on a ragged batch: pooled, tokens
    and all 20 gradients at rtol 1e-4, atol 1e-5 (x the gradient's largest
    entry, as tests/test_torch_encoder_train.py). The kernel's own piece
    length at this size is one piece (1024 tokens at least); 16 and 48 cut
    the 192 tokens into 12 and 4."""
    params, model, x, mask = setup
    want_p, want_t, want_g = jax_ref
    monkeypatch.setattr(gl, "logits_plain", _tree_logits)
    monkeypatch.setattr(pa, "token_sum", _piece_sum(chunk))
    model.zero_grad()
    w = train_weights(model, torch.float32)
    pooled, tok = et.encoder_train(to_torch(x), torch.from_numpy(mask), w, SEED, 0.0, 0.0,
                                   save_acts=True)
    _loss_torch(pooled, tok).backward()
    np.testing.assert_allclose(pooled.detach().numpy(), want_p, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tok.detach().numpy(), want_t, rtol=1e-4, atol=1e-5)
    got = {k: p.grad for k, p in model.named_parameters() if p.grad is not None}
    assert set(got) == {k for k in want_g if not k.startswith("projector")}
    for k, g in got.items():
        ref = want_g[k].numpy()
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-4, atol=1e-5 * scale, err_msg=k)


def test_logit_tree_is_a_reordering_and_the_pieces_cover_every_token():
    """The mirror's helpers: the xor tree sums the same 64 terms (equal to
    the plain sum in f64), and the kernel's piece length is a whole number of
    16-token stages, at least 1024 tokens unless the call is shorter, its
    pieces covering every token once, at the step's shapes."""
    v = torch.randn(5, 64, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(_logit_tree(v), v.sum(-1), rtol=1e-12, atol=1e-12)
    for Mo, No, tokens, batches in ((512, 512, 133120, 1), (1024, 512, 133120, 4),
                                    (128, 2048, 532480, 1), (512, 544, 133120, 1),
                                    (128, 512, 80, 1)):
        c = et.ffma_wgrad_chunk(Mo, No, tokens, batches)
        assert c % et.FFMA_STAGE == 0 and (c >= et.FFMA_SPLIT_MIN or c >= tokens)
        pieces = -(-tokens // c)
        assert (pieces - 1) * c < tokens <= pieces * c
        tiles = -(-Mo // 128) * -(-No // 128) * batches
        assert pieces * tiles <= et.FFMA_SPLIT_BLOCKS + tiles
