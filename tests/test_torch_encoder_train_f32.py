"""K6 / K7 with f32 operands (the JAX package's parity route, `--precision
float32`), checked on the CPU: the residual buffers' bytes against the
save/recompute gate's reckoning, the operand checks' refusal of mixed bf16 /
f32 sets, the train step's route for an f32 step on the card, and plain
mirrors of the f32 kernels' arithmetic against the JAX package's
interpret-mode `encoder_train` in f32:

- the split-TF32 route K6 / K7 run (csrc/gemm_tf32.cuh): every product's
  operands cut into TF32 hi and lo (`gated_pool.split_tf32`), each 32-deep k
  tile a fresh partial lo.hi + hi.lo + hi.hi (here exact in float64, then
  rounded to f32), the partials added in k order in f32; the weight
  gradients' tokens in pieces of whole k tiles added in piece order
  (`tf32_wgrad_chunk`); the gate logits' 64-column partials each four
  threads' 16-column sums added in xor order (gemm_tf32.cuh::
  epilogue_gates); and a hi-only control that must miss the bar;
- the FFMA order that the per-op kernels 15-18 with f32 operands still run
  (the gate logits' 64-column partials each a fixed tree of 16 four-column
  sums, csrc/gemm_ffma.cuh::epilogue_gates; the weight gradients' token
  sums in pieces added in piece order, gemm_ffma.cuh::wgrad).

The kernels themselves are held against their plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py)."""

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
from madeleine_torch.ops.gated_pool import round_tf32, split_tf32
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


# ---------------------------------------------------------------------------
# the split-TF32 route's arithmetic (K6 / K7, csrc/gemm_tf32.cuh), mirrored
# ---------------------------------------------------------------------------

def _tf32_dot(a, b, hi_only=False):
    """a [R, K] . b [K, C] as the split-TF32 GEMM sums it: per 32-deep k tile
    a fresh partial of lo.hi + hi.lo + hi.hi (hi.hi alone with hi_only),
    exact in float64 and rounded to f32, the partials added in k order in
    f32 (K padded with zeros to whole tiles, as TMA fills them)."""
    kt = et.TF32_KTILE
    K = a.shape[1]
    pad = -K % kt
    a = torch.nn.functional.pad(a.float(), (0, pad))
    b = torch.nn.functional.pad(b.float(), (0, 0, 0, pad))
    n = (K + pad) // kt
    a3 = a.reshape(a.shape[0], n, kt).transpose(0, 1)        # [n, R, 32]
    b3 = b.reshape(n, kt, b.shape[1])                          # [n, 32, C]
    (ah, al), (bh, bl) = split_tf32(a3), split_tf32(b3)
    parts = ah.double() @ bh.double()
    if not hi_only:
        parts = parts + (al.double() @ bh.double() + ah.double() @ bl.double())
    parts = parts.float()
    acc = parts[0]
    for i in range(1, n):
        acc = acc + parts[i]
    return acc


def _tf32_patches(chunk, hi_only=False):
    """{(module, name): mirror} of the plain versions' product hooks and the
    logits in the split-TF32 kernels' orders; chunk: the weight gradients'
    piece length (None: `tf32_wgrad_chunk` of the product alone, which the
    kernel's batched gate gradient equals below 1024 tokens: one piece)."""
    def mm(a, w):                       # a [..., K] . w [N, K]^T
        out = _tf32_dot(a.reshape(-1, a.shape[-1]), w.float().T, hi_only)
        return out.reshape(*a.shape[:-1], w.shape[0])

    def mm_nn(a, w):                    # a [..., K] . w [K, N]
        out = _tf32_dot(a.reshape(-1, a.shape[-1]), w.float(), hi_only)
        return out.reshape(*a.shape[:-1], w.shape[1])

    def token_sum(a, b):
        a2, b2 = a.reshape(-1, a.shape[-1]).float(), b.reshape(-1, b.shape[-1]).float()
        n = a2.shape[0]
        c = et.tf32_wgrad_chunk(a2.shape[1], b2.shape[1], n, 1) if chunk is None else chunk
        assert c % et.TF32_KTILE == 0
        out = _tf32_dot(a2[:c].T, b2[:c], hi_only)
        for s0 in range(c, n, c):
            out = out + _tf32_dot(a2[s0:s0 + c].T, b2[s0:s0 + c], hi_only)
        return out

    def head_mm(yh, w):                 # per head, K = e
        return torch.stack([mm(yh[:, :, h], w[h]) for h in range(w.shape[0])], dim=2)

    def gate_dy(dza, dzb, wa, wb):      # per head one product over K = 2f: [dza | dzb]
        return torch.stack([mm_nn(torch.cat([dza[:, :, h], dzb[:, :, h]], -1),
                                  torch.cat([wa[h], wb[h]], 0)) for h in range(wa.shape[0])],
                           dim=2)

    return {(pa, "mm"): mm, (pa, "mm_nn"): mm_nn, (pa, "token_sum"): token_sum,
            (gl, "head_mm"): head_mm, (gl, "gate_dy"): gate_dy,
            (gl, "logits_plain"): _wgmma_logits}


def _quad_chunk(terms):
    """The split-TF32 gate epilogue's sum over a 64-column chunk [..., 64]:
    thread q (of four) holds columns 8 k + 2 q and 8 k + 2 q + 1 for k = 0..7
    and adds them in that order; then (s0 + s1) + (s2 + s3), the xor steps 1
    and 2 (csrc/gemm_tf32.cuh::epilogue_gates)."""
    q = terms.reshape(*terms.shape[:-1], 8, 4, 2)
    s = q[..., 0, :, 0]
    for k in range(8):
        s = s if k == 0 else s + q[..., k, :, 0]
        s = s + q[..., k, :, 1]
    return (s[..., 0] + s[..., 1]) + (s[..., 2] + s[..., 3])


def _wgmma_logits(a_pre, b_pre, ma, mb, w):
    """`gl.logits_plain` in the split-TF32 gate epilogue's order: per
    64-column chunk `_quad_chunk`, the chunks added in chunk order
    (gate_logits_sum), then bc."""
    terms = (a_pre * ma) * (b_pre * mb) * w["wc"]
    parts = _quad_chunk(terms.reshape(*terms.shape[:-1], -1, et.GATE_CHUNK))
    l = parts[..., 0]
    for c in range(1, parts.shape[-1]):
        l = l + parts[..., c]
    return l + w["bc"]


def _run_mirror(setup, jax_ref, patches, monkeypatch):
    """The plain op under `patches` at rate 0 on the ragged batch, against
    JAX's interpret-mode f32 op: {name: excess over rtol 1e-4 / atol 1e-5 (x
    the gradient's largest entry)}, <= 0 within the bar."""
    params, model, x, mask = setup
    want_p, want_t, want_g = jax_ref
    for (mod, name), fn in patches.items():
        monkeypatch.setattr(mod, name, fn)
    model.zero_grad()
    w = train_weights(model, torch.float32)
    pooled, tok = et.encoder_train(to_torch(x), torch.from_numpy(mask), w, SEED, 0.0, 0.0,
                                   save_acts=True)
    _loss_torch(pooled, tok).backward()

    def excess(got, ref, atol):
        return float((np.abs(got - ref) - (atol + 1e-4 * np.abs(ref))).max())

    out = {"pooled": excess(pooled.detach().numpy(), want_p, 1e-5),
           "tok": excess(tok.detach().numpy(), want_t, 1e-5)}
    got = {k: p.grad for k, p in model.named_parameters() if p.grad is not None}
    assert set(got) == {k for k in want_g if not k.startswith("projector")}
    for k, g in got.items():
        ref = want_g[k].numpy()
        out[k] = excess(g.numpy(), ref, 1e-5 * max(1.0, float(np.abs(ref).max())))
    return out


@pytest.mark.parametrize("chunk", [None, 32, 64], ids=["kernel", "6_pieces", "3_pieces"])
def test_tf32_kernel_order_mirror_matches_jax(setup, jax_ref, chunk, monkeypatch):
    """The plain op with the split-TF32 kernels' arithmetic and sum orders
    (every product's per-k-tile partials, the weight gradients' token
    pieces, the gate logits' quad order) against JAX's interpret-mode f32 op
    at rate 0 on a ragged batch: pooled, tokens and all 20 gradients at
    rtol 1e-4, atol 1e-5 (x the gradient's largest entry). The kernel's own
    piece length at this size is one piece; 32 and 64 cut the 192 tokens
    into 6 and 3."""
    bad = {k: v for k, v in _run_mirror(setup, jax_ref, _tf32_patches(chunk),
                                        monkeypatch).items() if not v <= 0}
    assert not bad, bad


def test_tf32_hi_only_control_misses_the_bar(setup, jax_ref, monkeypatch):
    """The control: the same mirror with the lo terms dropped (hi.hi alone, a
    single TF32 product, 11 significant bits an operand) lies past the bar,
    so the bar can see a route that loses the split."""
    out = _run_mirror(setup, jax_ref, _tf32_patches(None, hi_only=True), monkeypatch)
    assert max(out.values()) > 0, out


def test_tf32_helpers_split_order_and_pieces():
    """The mirror's helpers: hi + lo = x within 2^-22 |x| with both on the
    TF32 grid; `_tf32_dot` within 1e-6 of the float64 product; the quad
    order sums the same 64 terms (equal to the plain sum in float64); the
    TF32 piece length is a whole number of 32-token k tiles, at least 1024
    tokens unless the call is shorter, its pieces covering every token once,
    at the step's shapes."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4096, generator=g) * 10.0 ** torch.randint(-3, 4, (4096,), generator=g)
    hi, lo = split_tf32(x)
    assert torch.equal(round_tf32(hi), hi) and torch.equal(round_tf32(lo), lo)
    assert bool(((hi.double() + lo.double() - x.double()).abs()
                 <= 2.0 ** -22 * x.double().abs()).all())
    a, b = torch.randn(40, 200, generator=g), torch.randn(200, 24, generator=g)
    ref = a.double() @ b.double()
    rel = lambda v: ((v.double() - ref).norm() / ref.norm()).item()   # noqa: E731
    assert rel(_tf32_dot(a, b)) <= 1e-6 < rel(_tf32_dot(a, b, hi_only=True))
    v = torch.randn(5, 64, dtype=torch.float64, generator=g)
    torch.testing.assert_close(_quad_chunk(v), v.sum(-1), rtol=1e-12, atol=1e-12)
    for Mo, No, tokens, batches in ((512, 512, 133120, 1), (1024, 512, 133120, 4),
                                    (128, 2048, 532480, 1), (512, 544, 133120, 1),
                                    (128, 512, 80, 1)):
        c = et.tf32_wgrad_chunk(Mo, No, tokens, batches)
        assert c % et.TF32_KTILE == 0 and (c >= et.FFMA_SPLIT_MIN or c >= tokens)
        pieces = -(-tokens // c)
        assert (pieces - 1) * c < tokens <= pieces * c
        tiles = -(-Mo // 128) * -(-No // 128) * batches
        assert pieces * tiles <= et.FFMA_SPLIT_BLOCKS + tiles


@pytest.mark.parametrize("rows", [65, 16], ids=["b65", "b16"])
def test_f32_slide_projection_is_the_same_at_any_batch_size(setup, rows):
    """ROADMAP C2: the f32 slide projector gives every row the same value
    whether it gets the whole batch, two halves (two data-parallel ranks) or
    one row at a time, within 1e-6 of the f32 product (its correctly
    rounded value); an f32 GEMM does not (the control: `_linear_head_major`
    in f32 differs somewhere); bf16 keeps the bf16 product."""
    from madeleine_torch.models import madeleine as port

    _, model, _, _ = setup
    emb = model.wsi_embedders
    pooled = torch.randn(rows, emb.n_heads, emb.hidden_dim,
                         generator=torch.Generator().manual_seed(rows))
    whole = port._slide_projection(model, pooled, torch.float32)
    h = rows // 2
    halves = torch.cat([port._slide_projection(model, p, torch.float32)
                        for p in (pooled[:h], pooled[h:])])
    single = torch.cat([port._slide_projection(model, pooled[i:i + 1], torch.float32)
                        for i in range(rows)])
    assert whole.dtype == torch.float32
    assert torch.equal(whole, halves) and torch.equal(whole, single)
    f32 = port._linear_head_major(model, model.projector, pooled, torch.float32)
    assert float((whole - f32).norm() / f32.norm()) <= 1e-6
    f32_rows = torch.cat([port._linear_head_major(model, model.projector, pooled[i:i + 1],
                                                  torch.float32) for i in range(rows)])
    assert not torch.equal(f32, f32_rows)
    bf = pooled.to(torch.bfloat16)
    assert torch.equal(port._slide_projection(model, bf, torch.bfloat16),
                       port._linear_head_major(model, model.projector, bf, torch.bfloat16))
