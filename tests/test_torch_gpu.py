"""Tests of the port that need a CUDA device (marked `gpu`; they skip elsewhere).

This file imports neither JAX nor the JAX package, so it also runs on a GPU
machine without them:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from madeleine_torch.config import MadeleineConfig
from madeleine_torch.models.abmil import abmil_embed, encoder_weights
from madeleine_torch.models.madeleine import MADELEINE, init_madeleine
from madeleine_torch.ops import encode_fused as ef
from madeleine_torch.ops import gated_pool as gp
from madeleine_torch.ops.attn_pool import mask_bias

pytestmark = pytest.mark.gpu

PEAK_WC_SCALE = 16.0   # as chip_smoke.py: attention logits spread by several units


@pytest.fixture()
def cuda_device():
    """Decided inside the fixture, so every test worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from madeleine_torch.utils.device import resolve_device

    return resolve_device("cuda")


def _model(device, precision="bfloat16"):
    cfg = MadeleineConfig(precision=precision).finalize()   # published widths
    return init_madeleine(MADELEINE(cfg), torch.Generator().manual_seed(0)).to(device).eval()


def _bags(device, lengths, t, dtype):
    x = torch.randn(len(lengths), t, 512, generator=torch.Generator().manual_seed(1))
    mask = torch.arange(t)[None, :] < torch.as_tensor(lengths)[:, None]
    return x.to(device, dtype), mask.to(device)


# K1's shapes: (lengths, t, d_in); "ragged" was the only case before the
# live-tile route, "t4057" has a partial last tile, "d_in544" the stain-encoded
# input; the "extract" cases are extraction's calls (262,144 tokens per batch),
# ragged bags of the bucket and empty padding bags, which run several chunks:
# bucket 8192 at its batch of 32 (8 chunks, three of them with no live tile)
# and bucket 1024 at its batch of 64 (2 chunks)
_EXTRACT = np.random.default_rng(7)
K1_CASES = {"ragged": ([1000, 613, 0], 1000, 512), "t4057": ([4057, 4033], 4057, 512),
            "d_in544": ([1000, 613, 0], 1000, 544),
            "extract_b32": (_EXTRACT.integers(4097, 8193, 24).tolist() + [0] * 8, 8192, 512),
            "extract_b64": (_EXTRACT.integers(513, 1025, 60).tolist() + [0] * 4, 1024, 512)}


@pytest.mark.parametrize("case", list(K1_CASES))
@pytest.mark.parametrize("wc_scale", [1.0, PEAK_WC_SCALE])
def test_encode_fused_kernel_matches_plain(cuda_device, wc_scale, case):
    """bf16, atol 3e-2 on the bf16 output; a partial last tile, an empty bag
    and calls that run several chunks, one of them with no live tile.
    At the init's scale the logits spread by well under one unit and the pool
    is nearly uniform; scaling wc spreads them by several units, so a kernel
    whose gates or logits were wrong would miss the bar. The control: the
    uniform pool (wc = 0) must differ from the peaked one by more than atol.
    The call takes the live-tile route (counters), twice bitwise equal; the
    first design, where its shared memory holds d_in, agrees at the same bar."""
    atol = 3e-2
    lengths, t, d_in = K1_CASES[case]
    b = len(lengths)
    model = _model(cuda_device)
    w = ef.kernel_weights(encoder_weights(model.wsi_embedders), torch.bfloat16)
    w["wc"] = w["wc"] * wc_scale
    if d_in != 512:
        g = torch.Generator().manual_seed(5)
        w["w1"] = (torch.randn(512, d_in, generator=g) / d_in ** 0.5).to(cuda_device,
                                                                           torch.bfloat16)
    x = torch.randn(b, t, d_in, generator=torch.Generator().manual_seed(1))
    x = x.to(cuda_device, torch.bfloat16)
    mask = (torch.arange(t)[None, :] < torch.as_tensor(lengths)[:, None]).to(cuda_device)
    bias = mask_bias(mask, b, t, 4, cuda_device)
    if case.startswith("extract"):
        rows = ef.live_tiles_plain(bias)[2].tolist()
        assert ef.chunk_plan(b, t)[2] > 1 and sum(r > 0 for r in rows) > 1
        assert case != "extract_b32" or min(rows) == 0
    before = (ef.launches, ef.rowtile_launches)
    got = ef.encode_fused_cuda(x, bias, w)
    assert (ef.launches, ef.rowtile_launches) == (before[0] + 1, before[1])
    assert torch.equal(got, ef.encode_fused_cuda(x, bias, w))
    want = ef.encode_pool_fused_plain(x, bias, w)
    assert (got.float() - want.float()).abs().max().item() <= atol
    for i, n in enumerate(lengths):
        if n == 0:
            assert (got[i] == 0).all()
    first = ef.encode_fused_rowtile_cuda(x, bias, w)
    assert (first.float() - want.float()).abs().max().item() <= atol
    if wc_scale != 1.0:
        uniform = ef.encode_pool_fused_plain(x, bias, dict(w, wc=torch.zeros_like(w["wc"])))
        assert (uniform.float() - want.float()).abs().max().item() > atol


def test_gated_pool_kernel_matches_plain(cuda_device):
    """f32, rtol 1e-4 / atol 1e-5."""
    g = torch.Generator().manual_seed(0)
    nh, e, f, b, t = 4, 512, 512, 2, 300
    w = {"wa": torch.randn(nh, f, e, generator=g) / e ** 0.5,
         "ba": torch.randn(nh, f, generator=g) * 0.1,
         "wb": torch.randn(nh, f, e, generator=g) / e ** 0.5,
         "bb": torch.randn(nh, f, generator=g) * 0.1,
         "wc": torch.randn(nh, f, generator=g) / f ** 0.5,
         "bc": torch.randn(nh, generator=g)}
    w = {k: v.to(cuda_device) for k, v in w.items()}
    y = torch.randn(b, t, nh * e, generator=g).to(cuda_device)
    mask = (torch.arange(t)[None, :] < torch.tensor([[300], [77]])).to(cuda_device)
    bias = mask_bias(mask, b, t, nh, cuda_device)
    torch.testing.assert_close(gp.gated_pool_cuda(y, bias, **gp.split_operands(**w)),
                               gp.gated_attention_pool_plain(y, bias, **w),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("wc_scale", [1.0, PEAK_WC_SCALE], ids=["init", "peaked"])
@pytest.mark.parametrize("t", [300, 4057])
def test_gated_pool_split_kernel_matches_plain_and_first_design(cuda_device, t, wc_scale):
    """K2's split-TF32 wgmma design against the plain version and the first
    design (FP32 FMA) at rtol 1e-4 / atol 1e-5: a ragged bag, an empty one
    (pools to 0), a partial last 128-token tile; peaked: wc scaled so that
    the logits spread by several units, where a uniform pool (wc = 0) misses
    the bar, and so does the plain version on TF32-rounded operands (the
    hi . hi term alone). Two launches are bitwise equal; each counts on its
    own counter; gated_attention_pool, which splits the stacked weights for
    its call, gives the same result as the operands split once."""
    g = torch.Generator().manual_seed(0)
    nh, e, f, b = 4, 512, 512, 3
    w = {"wa": torch.randn(nh, f, e, generator=g) / e ** 0.5,
         "ba": torch.randn(nh, f, generator=g) * 0.1,
         "wb": torch.randn(nh, f, e, generator=g) / e ** 0.5,
         "bb": torch.randn(nh, f, generator=g) * 0.1,
         "wc": torch.randn(nh, f, generator=g) / f ** 0.5 * wc_scale,
         "bc": torch.randn(nh, generator=g)}
    w = {k: v.to(cuda_device) for k, v in w.items()}
    y = torch.randn(b, t, nh * e, generator=g).to(cuda_device)
    lengths = torch.tensor([[t], [t // 3 + 5], [0]])
    mask = (torch.arange(t)[None, :] < lengths).to(cuda_device)
    bias = mask_bias(mask, b, t, nh, cuda_device)
    split = gp.split_operands(**w)
    before = (gp.launches, gp.ffma_launches)
    got = gp.gated_pool_cuda(y, bias, **split)
    assert (gp.launches, gp.ffma_launches) == (before[0] + 1, before[1])
    assert torch.equal(got, gp.gated_pool_cuda(y, bias, **split))
    assert torch.equal(got, gp.gated_attention_pool(w, y.reshape(b, t, nh, e),
                                                    mask).reshape(b, nh * e))
    want = gp.gated_attention_pool_plain(y, bias, **w)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert (got[2] == 0).all()
    first = gp.gated_pool_ffma_cuda(y, bias, **w)
    assert gp.ffma_launches == before[1] + 1
    torch.testing.assert_close(first, want, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got, first, rtol=1e-4, atol=1e-5)
    if wc_scale != 1.0:
        uniform = gp.gated_attention_pool_plain(y, bias, **dict(w, wc=torch.zeros_like(w["wc"])))
        assert ((uniform - want).abs() > 1e-5 + 1e-4 * want.abs()).any()
        tf32 = {k: gp.round_tf32(v) if k in ("wa", "wb") else v for k, v in w.items()}
        hi_only = gp.gated_attention_pool_plain(gp.round_tf32(y), bias, **tf32)
        assert ((hi_only - want).abs() > 1e-5 + 1e-4 * want.abs()).any()


def test_gated_pool_split_kernel_refuses_what_it_cannot_take(cuda_device):
    """e not a multiple of 32 (the TF32 k tile) and a y off a 16-byte
    boundary raise before any launch; the first design takes e % 16 == 0."""
    nh, f = 2, 64
    for e, ok_first in ((48, True), (40, False)):
        w = {"wa": torch.zeros(nh, f, e), "ba": torch.zeros(nh, f), "wb": torch.zeros(nh, f, e),
             "bb": torch.zeros(nh, f), "wc": torch.zeros(nh, f), "bc": torch.zeros(nh)}
        w = {k: v.to(cuda_device) for k, v in w.items()}
        y = torch.zeros(1, 64, nh * e, device=cuda_device)
        bias = mask_bias(None, 1, 64, nh, cuda_device)
        with pytest.raises(ValueError, match="unsupported shape"):
            gp.gated_pool_cuda(y, bias, **gp.split_operands(**w))
        if ok_first:
            assert gp.gated_pool_ffma_cuda(y, bias, **w).shape == (1, nh * e)
    e = 64
    w = {"wa": torch.zeros(nh, f, e), "ba": torch.zeros(nh, f), "wb": torch.zeros(nh, f, e),
         "bb": torch.zeros(nh, f), "wc": torch.zeros(nh, f), "bc": torch.zeros(nh)}
    w = {k: v.to(cuda_device) for k, v in w.items()}
    buf = torch.zeros(64 * nh * e + 1, device=cuda_device)
    before = gp.launches
    with pytest.raises(ValueError, match="16-byte boundary"):
        gp.gated_pool_cuda(buf[1:].view(1, 64, nh * e), mask_bias(None, 1, 64, nh, cuda_device),
                           **gp.split_operands(**w))
    assert gp.launches == before


@pytest.mark.parametrize("dtype,kernel,atol", [(torch.bfloat16, ef, 3e-2),
                                               (torch.float32, gp, 1e-5)])
def test_abmil_embed_routes_cuda_tensors_through_the_kernels(cuda_device, dtype, kernel, atol):
    model = _model(cuda_device)
    x, mask = _bags(cuda_device, [700, 64], 700, dtype)
    before = kernel.launches
    got = abmil_embed(model.wsi_embedders, x, mask=mask)
    assert kernel.launches == before + 1
    # the composable f32 path, which CPU tensors take
    want = abmil_embed(_model("cpu").wsi_embedders, x.float().cpu(), mask=mask.cpu())
    torch.testing.assert_close(got.float().cpu(), want, rtol=1e-4 if atol < 1e-4 else 0,
                               atol=atol)


def test_kernel_operands_rebuild_after_an_optimizer_step(cuda_device):
    """K1's operands are cached per weight state (abmil.kernel_operands). The
    trainer's AdamW (make_optimizer, at the learning rate its schedule gives
    count 0) changes the parameters in place: the cache must then rebuild, and an
    embed must equal one from operands built fresh, bit for bit."""
    from madeleine_torch.models.abmil import kernel_operands
    from madeleine_torch.train.optim import make_optimizer

    model = _model(cuda_device)
    emb = model.wsi_embedders
    x, mask = _bags(cuda_device, [700, 64], 700, torch.bfloat16)
    first = kernel_operands(emb, torch.bfloat16)
    before = abmil_embed(emb, x, mask=mask)
    opt, _ = make_optimizer(MadeleineConfig(precision="bfloat16", lr=1e-3,
                                            warmup=False).finalize(), emb.parameters(), 10)
    g = torch.Generator().manual_seed(3)
    for p in emb.parameters():
        p.grad = torch.randn(p.shape, generator=g).to(cuda_device)
    opt.step()
    second = kernel_operands(emb, torch.bfloat16)
    assert second is not first
    fresh = ef.kernel_weights(encoder_weights(emb), torch.bfloat16)
    for k, v in fresh.items():
        assert torch.equal(second[k], v), k
    got = abmil_embed(emb, x, mask=mask)
    assert torch.equal(got, ef.encode_pool_fused(fresh, x, mask))
    assert not torch.equal(got, before)


def test_kernels_raise_instead_of_falling_back(cuda_device):
    model = _model(cuda_device)
    w = ef.kernel_weights(encoder_weights(model.wsi_embedders), torch.bfloat16)
    x, _ = _bags(cuda_device, [64], 64, torch.float32)
    with pytest.raises(ValueError, match="bf16"):
        ef.encode_fused_cuda(x, mask_bias(None, 1, 64, 4, cuda_device), w)


def _train_operands(model):
    from madeleine_torch.models.madeleine import train_weights

    with torch.no_grad():
        return {k: v.detach().contiguous()
                for k, v in train_weights(model, torch.bfloat16).items()}


@pytest.mark.parametrize("rates", [(0.0, 0.0), (0.1, 0.25)])
def test_encoder_train_kernels_match_plain(cuda_device, rates):
    """K6 against its plain version (atol 3e-2 on pooled, tok and the valid
    logits, as K1), K7 against its plain version on the same residuals with a
    random pooled cotangent and dtok (relative Frobenius 1e-2 per gradient;
    bc, whose exact value is 0, atol 1e-4); a partial last tile and an empty
    bag; K7 twice gives bitwise-equal gradients."""
    from madeleine_torch.ops import encoder_train as et

    w = _train_operands(_model(cuda_device))
    x, mask = _bags(cuda_device, [300, 77, 0], 300, torch.bfloat16)
    bias = et.token_mask_bias(mask, 3, 300, cuda_device)
    got = et.encoder_train_fwd_cuda(x, bias, w, 5, 2, *rates)
    with torch.no_grad():
        want = et.encoder_train_fwd_plain(x, bias, w, 5, 2, *rates)
    for i in (0, 3):
        assert (got[i].float() - want[i].float()).abs().max().item() <= 3e-2
    assert (got[4] - want[4]).abs()[bias == 0].max().item() <= 3e-2
    assert (got[0][2] == 0).all()
    pooled32, m, s, _, l, saved = got
    gen = torch.Generator().manual_seed(3)
    g = torch.randn(3, pooled32.shape[1], generator=gen).to(cuda_device)
    dtok = torch.randn(3, 300, 128, generator=gen).to(cuda_device, torch.bfloat16)
    inner = (g * pooled32).reshape(3, 4, -1).sum(-1)
    args = (x, l, m, s, g, inner, dtok, saved, w, 5, 2, *rates)
    gk, gk2 = et.encoder_train_bwd_cuda(*args), et.encoder_train_bwd_cuda(*args)
    with torch.no_grad():
        gp = et.encoder_train_bwd_plain(*args)
    for k in et.W_KEYS:
        assert torch.equal(gk[k], gk2[k]), k
        if k == "bc":
            assert (gk[k] - gp[k]).abs().max().item() <= 1e-4
        else:
            assert ((gk[k] - gp[k]).norm() / gp[k].norm()).item() <= 1e-2, k


def test_train_step_launches_k6_k7_and_refuses_f32(cuda_device, monkeypatch):
    """A bf16 step on the card goes through K6 and K7 (one each per
    modality), an f32 softmax step through K6 and K7 with f32 operands (one
    each per modality, no bf16 launch); an f32 step on the per-op lane (a
    sigmoid activation, or softmax under MADELEINE_NO_FUSED_ENCODER) is no
    longer refused: it launches rows 15-18 with f32 operands, one each per
    modality, and no bf16 kernel of rows 15-18 and no K6/K7."""
    import numpy as np

    from madeleine_torch.ops import launches
    from madeleine_torch.train.optim import make_optimizer
    from madeleine_torch.train.trainer import make_train_step

    rng = np.random.default_rng(0)
    batch = {"feats": rng.standard_normal((4, 5, 256, 512)).astype(np.float32),
             "modality_labels": np.ones((4, 5), np.float32)}
    k67 = ("encoder_train_fwd", "encoder_train_bwd", "encoder_train_fwd_f32",
           "encoder_train_bwd_f32")
    rows = ("preattn_fwd", "preattn_bwd", "gated_logits_fwd", "gated_logits_bwd")
    rows_f32 = tuple(k + "_f32" for k in rows)
    for precision, activation, no_fused in (("bfloat16", "softmax", ""),
                                            ("float32", "softmax", ""),
                                            ("float32", "sigmoid", ""),
                                            ("float32", "softmax", "1")):
        monkeypatch.setenv("MADELEINE_NO_FUSED_ENCODER", no_fused)
        cfg = MadeleineConfig(precision=precision, local_loss="-1",
                              activation=activation).finalize()
        model = init_madeleine(MADELEINE(cfg), torch.Generator().manual_seed(0)).to(cuda_device)
        opt, sched = make_optimizer(cfg, model.parameters(), 10)
        step = make_train_step(cfg, model, opt, sched)
        launches.reset()
        _, metrics = step(batch, seed=1)
        counts = launches.read()
        assert not metrics["skipped"] and np.isfinite(float(metrics["loss"]))
        if activation == "softmax" and not no_fused:
            want = (5, 5, 0, 0) if precision == "bfloat16" else (0, 0, 5, 5)
            assert tuple(counts[k] for k in k67) == want
        else:   # the forward rows twice: cfg.remat recomputes each modality's body
            assert all(counts[k] == (10 if "_fwd" in k else 5) for k in rows_f32), counts
            assert not any(counts[k] for k in k67 + rows), counts


PEROP_F32_ROUTES = ("fwd", "bwd", "dx", "gates", "rate0")


@pytest.mark.parametrize("route", PEROP_F32_ROUTES)
def test_perop_f32_kernels_match_plain(cuda_device, route):
    """Rows 15-18 with f32 operands against their plain versions at ragged
    lengths' shape t = 300 (partial last tiles), row offset 2: fwd, rows 15
    and 17 at the real rates (0.1, 0.25); bwd, rows 16 and 18 there; dx,
    row 16 with the input gradient at d_in 544; gates, rows 17 and 18 with
    the attention logits peaked (wc x 16); rate0, all four at rate 0.
    Outputs within rtol 1e-4 / atol 1e-5, every gradient (dx, dy included)
    within 1e-4 relative Frobenius, bc within 1e-4 absolutely; two launches
    bitwise equal; the f32 counters move, the bf16 ones do not."""
    from madeleine_torch.models.madeleine import train_weights
    from madeleine_torch.ops import gated_logits as gl
    from madeleine_torch.ops import launches
    from madeleine_torch.ops import preattn as pa

    need_dx = route == "dx"
    rates = (0.0, 0.0) if route == "rate0" else (0.1, 0.25)
    cfg = MadeleineConfig(precision="float32", add_stain_encoding=need_dx).finalize()
    model = init_madeleine(MADELEINE(cfg), torch.Generator().manual_seed(0)).to(cuda_device)
    with torch.no_grad():
        w = {k: v.detach().contiguous() for k, v in train_weights(model, torch.float32).items()}
        if route == "gates":
            w["wc"] = w["wc"] * PEAK_WC_SCALE
    g = torch.Generator().manual_seed(9)
    x = torch.randn(3, 300, w["w1"].shape[1], generator=g).to(cuda_device)
    y = torch.randn(3, 300, w["w3"].shape[0], generator=g).to(cuda_device)
    dy = torch.randn(3, 300, w["w3"].shape[0], generator=g).to(cuda_device)
    dl = torch.randn(3, 300, w["wa"].shape[0], generator=g).to(cuda_device)
    runs = {"fwd": ("pa_fwd", "gl_fwd"), "bwd": ("pa_bwd", "gl_bwd"), "dx": ("pa_bwd",),
            "gates": ("gl_fwd", "gl_bwd"), "rate0": ("pa_fwd", "pa_bwd", "gl_fwd", "gl_bwd")}
    calls = {"pa_fwd": (pa.preattn_fwd_cuda, pa.preattn_fwd_plain, (x, w, 5, 2, rates[0]), {}),
             "pa_bwd": (pa.preattn_bwd_cuda, pa.preattn_bwd_plain, (x, dy, w, 5, 2, rates[0]),
                        {"need_dx": need_dx}),
             "gl_fwd": (gl.gated_logits_fwd_cuda, gl.gated_logits_fwd_plain,
                        (y, w, 5, 2, rates[1]), {}),
             "gl_bwd": (gl.gated_logits_bwd_cuda, gl.gated_logits_bwd_plain,
                        (y, dl, w, 5, 2, rates[1]), {})}
    launches.reset()
    for name in runs[route]:
        kern, plain, args, kw = calls[name]
        got, again = kern(*args, **kw), kern(*args, **kw)
        with torch.no_grad():
            want = plain(*args, **kw)
        if name.endswith("fwd"):
            assert got.dtype == torch.float32 and torch.equal(got, again), name
            assert _excess(got, want) <= 0, name
            continue
        assert set(got) == set(want) and ("x" in got) == (name == "pa_bwd" and need_dx)
        for k in want:
            assert got[k].dtype == torch.float32 and torch.equal(got[k], again[k]), (name, k)
            if k == "bc":
                assert (got[k] - want[k]).abs().max().item() <= 1e-4
            else:
                assert _rel(got[k], want[k]) <= 1e-4, (name, k)
    counts = launches.read()
    moved = {k: v for k, v in counts.items() if v}
    want_moved = {{"pa_fwd": "preattn_fwd_f32", "pa_bwd": "preattn_bwd_f32",
                   "gl_fwd": "gated_logits_fwd_f32", "gl_bwd": "gated_logits_bwd_f32"}[n]: 2
                  for n in runs[route]}
    assert moved == want_moved


def test_perop_kernels_refuse_a_mixed_operand_set(cuda_device):
    """On the card rows 15-18 refuse bf16 input with f32 weights, or f32
    input with one bf16 matrix, with a ValueError naming the operand, and
    their first designs refuse f32 operands: nothing launches."""
    from madeleine_torch.models.madeleine import train_weights
    from madeleine_torch.ops import gated_logits as gl
    from madeleine_torch.ops import launches
    from madeleine_torch.ops import preattn as pa

    model = _model(cuda_device, "float32")
    with torch.no_grad():
        w = {k: v.detach().contiguous() for k, v in train_weights(model, torch.float32).items()}
    x = torch.randn(2, 64, 512, device=cuda_device)
    y = torch.randn(2, 64, 2048, device=cuda_device)
    dl = torch.randn(2, 64, 4, device=cuda_device)
    launches.reset()
    with pytest.raises(ValueError, match="w1"):
        pa.preattn_fwd_cuda(x.bfloat16(), w, 1)
    with pytest.raises(ValueError, match="w3"):
        pa.preattn_bwd_cuda(x, y, dict(w, w3=w["w3"].bfloat16()), 1)
    with pytest.raises(ValueError, match="wa"):
        gl.gated_logits_fwd_cuda(y.bfloat16(), w, 1)
    with pytest.raises(ValueError, match="wb"):
        gl.gated_logits_bwd_cuda(y, dl, dict(w, wb=w["wb"].bfloat16()), 1)
    for first, args in ((pa.preattn_fwd_rowblock_cuda, (x, w, 1)),
                        (gl.gated_logits_fwd_rowblock_cuda, (y, w, 1)),
                        (gl.gated_logits_bwd_rowblock_cuda, (y, dl, w, 1))):
        with pytest.raises(ValueError, match="bf16 only"):
            first(*args)
    assert not any(launches.read().values())


def _got_costs(device, b, n, m, d=128, seed=0):
    """C, Cs, Ct, Cst as the GOT path builds them: random tokens ->
    cosine_cost -> threshold-ReLU, and the Cst outer sum."""
    from madeleine_torch.ops import losses as L
    from madeleine_torch.ops.got_glue import cst_plain

    g = torch.Generator().manual_seed(seed)
    v = torch.randn(b, n, d, generator=g).to(device)
    q = torch.randn(b, m, d, generator=g).to(device)
    C = L._threshold_relu(L.cosine_cost(v, q), None)
    Cs = L._threshold_relu(L.cosine_cost(v, v), None)
    Ct = L._threshold_relu(L.cosine_cost(q, q), None)
    return C, Cs, Ct, cst_plain(Cs, Ct)


def _rel(a, b):
    return ((a - b).norm() / b.norm()).item()


@pytest.mark.parametrize("shape", [(7, 256, 192), (260, 256, 256), (5, 100, 320), (3, 512, 512)],
                         ids=["odd", "step", "wide", "large"])
def test_ipot_and_gw_kernels_match_plain(cuda_device, shape):
    """K8 at (beta, iters) = (0.5, 30) and (0.1, 20), K9 with the loss's
    cotangent C, K10 at (0.1, 5 x 20), each against its plain version:
    relative Frobenius 1e-4 for T and gamma, 1e-3 for dC; a second launch of
    each is bitwise equal. K8, K9 and K10 take the route `transport_route`
    gives for the shape, read from the launch counters: the cluster route at
    the odd, step and wide (m > 256: its general path) shapes, the global
    route at the large one. K8's cluster route equals its global route bit
    for bit."""
    from madeleine_torch.ops import ipot as I
    from madeleine_torch.ops import launches

    _, n, m = shape
    C, Cs, Ct, Cst = _got_costs(cuda_device, *shape)
    before = launches.read()
    Ts = []
    for beta, iters in ((0.5, 30), (0.1, 20)):
        T = I.ipot_plan_cuda(C, beta, iters)
        assert torch.equal(T, I.ipot_plan_cuda(C, beta, iters))
        assert _rel(T, I.ipot_plan_plain(C, beta, iters)) <= 1e-4, (beta, iters)
        Ts.append(T)
    dC = I.ipot_plan_bwd_cuda(C, C, 0.5, 30)
    assert torch.equal(dC, I.ipot_plan_bwd_cuda(C, C, 0.5, 30))
    assert _rel(dC, I.ipot_plan_bwd_plain(C, C, 0.5, 30)) <= 1e-3
    gamma = I.gw_gamma_cuda(Cs, Ct, Cst, 0.1, 5, 20)
    assert torch.equal(gamma, I.gw_gamma_cuda(Cs, Ct, Cst, 0.1, 5, 20))
    assert _rel(gamma, I.gw_gamma_plain(Cs, Ct, Cst, 0.1, 5, 20)) <= 1e-4
    after = launches.read()
    for kernel, calls in (("ipot_fwd", 4), ("ipot_bwd", 2), ("gw_gamma", 2)):
        route, _ = I.transport_route(kernel, n, m)
        assert route == ("global" if n == 512 else "cluster")
        launched = {"cluster": after[kernel] - before[kernel],
                    "global": after[f"{kernel}_global"] - before[f"{kernel}_global"]}
        assert launched == {"cluster": calls * (route == "cluster"),
                            "global": calls * (route == "global")}, kernel
    # K8's cluster route at c = 4 sums in its global route's order
    if I.transport_route("ipot_fwd", n, m) == ("cluster", 4):
        for T, (beta, iters) in zip(Ts, ((0.5, 30), (0.1, 20))):
            assert torch.equal(T, I._ipot_fwd_global(C, beta, iters))


def test_ipot_kernels_raise_on_a_wrong_operand(cuda_device):
    """A kernel given an operand it does not take raises; nothing falls back
    to the plain version."""
    from madeleine_torch.ops import ipot as I

    C, Cs, Ct, Cst = _got_costs(cuda_device, 2, 64, 48)
    before = (I.fwd_launches, I.bwd_launches, I.gw_launches)
    with pytest.raises(ValueError, match="float32"):
        I.ipot_plan_cuda(C.double(), 0.5, 30)
    with pytest.raises(ValueError, match="non-contiguous"):
        I.ipot_plan_bwd_cuda(C, C.transpose(1, 2).contiguous().transpose(1, 2), 0.5, 30)
    with pytest.raises(ValueError, match="Ct"):
        I.gw_gamma_cuda(Cs, Cs, Cst, 0.1, 5, 20)
    assert (I.fwd_launches, I.bwd_launches, I.gw_launches) == before


def test_got_train_step_launches_all_five_train_kernels(cuda_device):
    """A bf16 InfoNCE + GOT step on the card goes through K6 and K7 (once
    per modality) and K8, K9 and K10 (once each: all stain pairs batched)."""
    import numpy as np

    from madeleine_torch.ops import encoder_train as et
    from madeleine_torch.ops import ipot as I
    from madeleine_torch.train.optim import make_optimizer
    from madeleine_torch.train.trainer import make_train_step

    rng = np.random.default_rng(0)
    batch = {"feats": rng.standard_normal((4, 5, 256, 512)).astype(np.float32),
             "modality_labels": np.ones((4, 5), np.float32)}
    cfg = MadeleineConfig(precision="bfloat16", local_loss="got", got_subsample=64).finalize()
    model = init_madeleine(MADELEINE(cfg), torch.Generator().manual_seed(0)).to(cuda_device)
    opt, sched = make_optimizer(cfg, model.parameters(), 10)
    step = make_train_step(cfg, model, opt, sched)
    before = (et.fwd_launches, et.bwd_launches, I.fwd_launches, I.bwd_launches, I.gw_launches)
    _, metrics = step(batch, seed=1)
    assert not metrics["skipped"] and np.isfinite(float(metrics["loss"]))
    after = (et.fwd_launches, et.bwd_launches, I.fwd_launches, I.bwd_launches, I.gw_launches)
    assert tuple(a - b for a, b in zip(after, before)) == (5, 5, 1, 1, 1)


def _glue_inputs(device, b, n, m, d=128, seed=0):
    """C0, Cs0, Ct0 cosine costs of random tokens, per-problem thresholds
    [b, 3] and a transport plan of the thresholded costs."""
    from madeleine_torch.ops import got_glue as G
    from madeleine_torch.ops import ipot as I
    from madeleine_torch.ops import losses as L

    g = torch.Generator().manual_seed(seed)
    v = torch.randn(b, n, d, generator=g).to(device)
    q = torch.randn(b, m, d, generator=g).to(device)
    X0 = (L.cosine_cost(v, q), L.cosine_cost(v, v), L.cosine_cost(q, q))
    thr = torch.stack([x.amin((1, 2)) + 0.1 * (x.amax((1, 2)) - x.amin((1, 2))) for x in X0],
                      dim=1).contiguous()
    _, Cs, Ct, Cst = G.threshold_build_plain(*X0, thr)
    return X0, thr, I.gw_gamma_plain(Cs, Ct, Cst, 0.1, 5, 20)


def test_glue_kernels_match_plain(cuda_device):
    """K11-K14 against their plain versions at (7, 256, 192), relative
    Frobenius per output: 1e-6 for K11 and K12's dC0/dCs0/dCt0, 1e-5 for
    K12's dthr and for K13/K14; a second launch of each is bitwise equal.
    K14 is also held bit for bit against its first design (the row-block
    entry point) there and at the ragged (5, 100, 320); K13 (its tiled
    route, read from the counters) against its first design at 1e-5 at both
    shapes, and against its plain version at the ragged one."""
    from madeleine_torch.ops import got_glue as G

    X0, thr, gamma = _glue_inputs(cuda_device, 7, 256, 192)
    outs = G.threshold_build_cuda(*X0, thr)
    assert all(torch.equal(a, b) for a, b in zip(outs, G.threshold_build_cuda(*X0, thr)))
    for got, want in zip(outs, G.threshold_build_plain(*X0, thr)):
        assert _rel(got, want) <= 1e-6
    g = torch.Generator().manual_seed(1)
    cots = [torch.randn(o.shape, generator=g).to(cuda_device) for o in outs]
    grads = G.threshold_build_bwd_cuda(*X0, thr, *cots)
    again = G.threshold_build_bwd_cuda(*X0, thr, *cots)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    for name, got, want in zip(("dC0", "dCs0", "dCt0", "dthr"), grads,
                               G.threshold_build_bwd_plain(*X0, thr, *cots)):
        assert _rel(got, want) <= (1e-5 if name == "dthr" else 1e-6), name
    _, Cs, Ct, Cst = outs
    counts = lambda: (G.gwt_fwd_launches, G.gwt_fwd_rowblock_launches)
    before = counts()
    out = G.gw_trace_cuda(Cs, Ct, Cst, gamma)
    assert torch.equal(out, G.gw_trace_cuda(Cs, Ct, Cst, gamma))
    assert counts() == (before[0] + 2, before[1])
    assert _rel(out, G.gw_trace_plain(Cs, Ct, Cst, gamma)) <= 1e-5
    assert _rel(out, G.gw_trace_rowblock_cuda(Cs, Ct, Cst, gamma)) <= 1e-5
    dout = torch.randn(7, generator=g).to(cuda_device)
    grads = G.gw_trace_bwd_cuda(Cs, Ct, gamma, dout)
    again = G.gw_trace_bwd_cuda(Cs, Ct, gamma, dout)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    for got, want in zip(grads, G.gw_trace_bwd_plain(Cs, Ct, Cst, gamma, dout)):
        assert _rel(got, want) <= 1e-5
    assert all(torch.equal(a, b)
               for a, b in zip(grads, G.gw_trace_bwd_rowblock_cuda(Cs, Ct, gamma, dout)))
    X0, thr, gamma = _glue_inputs(cuda_device, 5, 100, 320, seed=3)
    _, Cs, Ct, Cst = G.threshold_build_cuda(*X0, thr)
    out = G.gw_trace_cuda(Cs, Ct, Cst, gamma)
    assert torch.equal(out, G.gw_trace_cuda(Cs, Ct, Cst, gamma))
    assert _rel(out, G.gw_trace_plain(Cs, Ct, Cst, gamma)) <= 1e-5
    assert _rel(out, G.gw_trace_rowblock_cuda(Cs, Ct, Cst, gamma)) <= 1e-5
    dout = torch.randn(5, generator=g).to(cuda_device)
    grads = G.gw_trace_bwd_cuda(Cs, Ct, gamma, dout)
    for got, want in zip(grads, G.gw_trace_bwd_plain(Cs, Ct, Cst, gamma, dout)):
        assert _rel(got, want) <= 1e-5
    assert all(torch.equal(a, b)
               for a, b in zip(grads, G.gw_trace_bwd_rowblock_cuda(Cs, Ct, gamma, dout)))


def test_got_loss_multi_launches_the_glue_kernels_and_raises(cuda_device):
    """got_loss_multi forward + backward on the card launches K11-K14 once
    each; a glue kernel given an operand it does not take raises, and nothing
    falls back to the plain version."""
    from madeleine_torch.ops import got_glue as G
    from madeleine_torch.ops import losses as L

    g = torch.Generator().manual_seed(2)
    v = torch.randn(2, 3, 64, 16, generator=g).to(cuda_device).requires_grad_(True)
    q = torch.randn(2, 3, 64, 16, generator=g).to(cuda_device).requires_grad_(True)

    def counts():
        return (G.tb_fwd_launches, G.tb_bwd_launches, G.gwt_fwd_launches, G.gwt_bwd_launches)

    before = counts()
    loss = L.got_loss_multi(v, q)
    loss.sum().backward()
    assert torch.isfinite(loss).all() and torch.isfinite(v.grad).all()
    assert tuple(a - b for a, b in zip(counts(), before)) == (1, 1, 1, 1)
    X0, thr, gamma = _glue_inputs(cuda_device, 2, 32, 24)
    before = counts()
    with pytest.raises(ValueError, match="thr"):
        G.threshold_build_cuda(*X0, thr[:, :2].contiguous())
    with pytest.raises(ValueError, match="non-contiguous"):
        G.gw_trace_cuda(X0[1], X0[2], X0[0], gamma.transpose(1, 2).contiguous().transpose(1, 2))
    assert counts() == before


@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 3e-2), (torch.float32, 1e-5)],
                         ids=["bf16", "f32"])
def test_attn_pool_kernel_matches_plain(cuda_device, dtype, atol):
    """K3 against its plain version at t = 1000 (a partial last
    tile), ragged bags and an empty one (pools to 0), with logits spread by
    several units; bf16 atol 3e-2 on the bf16 output, f32 rtol 1e-4 / atol
    1e-5; two launches bitwise equal."""
    from madeleine_torch.ops import attn_pool as ap

    g = torch.Generator().manual_seed(4)
    b, t, nh, e = 3, 1000, 4, 512
    y = torch.randn(b, t, nh * e, generator=g).to(cuda_device, dtype)
    mask = (torch.arange(t)[None, :] < torch.tensor([[1000], [333], [0]])).to(cuda_device)
    l = (4.0 * torch.randn(b, t, nh, generator=g)).to(cuda_device)
    l = l.masked_fill(~mask[..., None], ap.NEG_INF).contiguous()
    before = ap.launches
    got = ap.attn_pool_cuda(y, l)
    assert torch.equal(got, ap.attn_pool_cuda(y, l)) and ap.launches == before + 2
    want = ap.softmax_pool_plain(l, y.view(b, t, nh, e)).to(dtype)
    assert got.dtype == dtype and (got[2] == 0).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=0 if dtype != torch.float32
                               else 1e-4, atol=atol)


def test_eval_forward_launches_k3_per_modality(cuda_device):
    """forward_train(train=False) on the card pools each modality through K3
    and agrees with the same forward of the f32 model on the CPU (bf16 atol
    5e-2 on the slide embeddings)."""
    from madeleine_torch.models.madeleine import forward_train
    from madeleine_torch.ops import attn_pool as ap

    cfg = MadeleineConfig(precision="bfloat16", add_stain_encoding=True).finalize()
    model = init_madeleine(MADELEINE(cfg), torch.Generator().manual_seed(0)).eval()
    x = torch.randn(2, 5, 300, 512, generator=torch.Generator().manual_seed(5))
    want_s, _ = forward_train(model, x, train=False)
    before = ap.launches
    got_s, got_t = forward_train(model.to(cuda_device), x.to(cuda_device, torch.bfloat16),
                                 train=False)
    assert ap.launches == before + 5
    assert got_t.shape == (2, 5, 300, 128) and torch.isfinite(got_t.float()).all()
    torch.testing.assert_close(got_s.float().cpu(), want_s, rtol=0, atol=5e-2)


def test_encoder_train_dx_matches_plain(cuda_device):
    """K7's need_dx route at d_in 544 (512 + the 32 stain columns) against
    the plain dx (relative Frobenius 1e-2, as the other gradients), with a
    partial last tile of the 128-wide GEMM (N = 544); without need_dx K7
    returns no dx."""
    from madeleine_torch.ops import encoder_train as et

    cfg = MadeleineConfig(precision="bfloat16", add_stain_encoding=True).finalize()
    model = init_madeleine(MADELEINE(cfg), torch.Generator().manual_seed(0)).to(cuda_device)
    w = _train_operands(model)
    g = torch.Generator().manual_seed(6)
    x = torch.randn(3, 300, 544, generator=g).to(cuda_device, torch.bfloat16)
    bias = et.token_mask_bias(None, 3, 300, cuda_device)
    pooled32, m, s, _, l, saved = et.encoder_train_fwd_cuda(x, bias, w, 5, 0, 0.1, 0.25)
    gp = torch.randn(3, pooled32.shape[1], generator=g).to(cuda_device)
    dtok = torch.randn(3, 300, 128, generator=g).to(cuda_device, torch.bfloat16)
    inner = (gp * pooled32).reshape(3, 4, -1).sum(-1)
    args = (x, l, m, s, gp, inner, dtok, saved, w, 5, 0, 0.1, 0.25)
    gk = et.encoder_train_bwd_cuda(*args, need_dx=True)
    with torch.no_grad():
        want = et.encoder_train_bwd_plain(*args, need_dx=True)
    assert gk["x"].dtype == torch.bfloat16 and gk["x"].shape == x.shape
    assert torch.equal(gk["x"], et.encoder_train_bwd_cuda(*args, need_dx=True)["x"])
    assert _rel(gk["x"].float(), want["x"].float()) <= 1e-2
    assert _rel(gk["w1"], want["w1"]) <= 1e-2
    assert "x" not in et.encoder_train_bwd_cuda(*args)


@pytest.mark.parametrize("need_dx", [False, True])
def test_encoder_train_recompute_route_equals_save_route(cuda_device, need_dx):
    """K7's recompute route (saved None: K6's own layer and gate code re-run
    inside K7) gives the save route's gradients, and dx, bit for bit, at
    ragged lengths with an empty bag and a partial last tile, real rates
    and row offset 2; K6 without saves gives the save route's outputs bit
    for bit; the autograd op takes each route by save_acts (route counters)."""
    from madeleine_torch.ops import encoder_train as et

    cfg = MadeleineConfig(precision="bfloat16", add_stain_encoding=need_dx).finalize()
    model = init_madeleine(MADELEINE(cfg), torch.Generator().manual_seed(0)).to(cuda_device)
    w = _train_operands(model)
    d_in = w["w1"].shape[1]
    g = torch.Generator().manual_seed(9)
    x = torch.randn(3, 300, d_in, generator=g).to(cuda_device, torch.bfloat16)
    mask = (torch.arange(300)[None, :] < torch.tensor([[300], [77], [0]])).to(cuda_device)
    bias = et.token_mask_bias(mask, 3, 300, cuda_device)
    fwd = et.encoder_train_fwd_cuda(x, bias, w, 5, 2, 0.1, 0.25)
    nosave = et.encoder_train_fwd_cuda(x, bias, w, 5, 2, 0.1, 0.25, save=False)
    assert nosave[5] is None and all(torch.equal(a, b) for a, b in zip(fwd[:5], nosave[:5]))
    pooled32, m, s, _, l, saved = fwd
    gp = torch.randn(3, pooled32.shape[1], generator=g).to(cuda_device)
    dtok = torch.randn(3, 300, 128, generator=g).to(cuda_device, torch.bfloat16)
    inner = (gp * pooled32).reshape(3, 4, -1).sum(-1)
    args = [x, l, m, s, gp, inner, dtok, saved, w, 5, 2, 0.1, 0.25]
    want = et.encoder_train_bwd_cuda(*args, need_dx=need_dx)
    args[7] = None
    before = et.bwd_recompute_launches
    got = et.encoder_train_bwd_cuda(*args, need_dx=need_dx)
    assert et.bwd_recompute_launches == before + 1
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    with torch.no_grad():
        plain = et.encoder_train_bwd_plain(*args, need_dx=need_dx)
    assert all(_rel(got[k].float(), plain[k].float()) <= 1e-2 for k in want if k != "bc")
    for save_acts, n in ((True, 0), (False, 1)):
        before = (et.fwd_nosave_launches, et.bwd_recompute_launches)
        p, t = et.encoder_train(x, mask, {k: v.requires_grad_(True) for k, v in w.items()}, 5,
                                need_dx=False, save_acts=save_acts)
        (p.float().sum() + t.float().sum()).backward()
        assert (et.fwd_nosave_launches, et.bwd_recompute_launches) == (before[0] + n,
                                                                         before[1] + n)


F32_ROUTES = ("save", "recompute", "dx", "views", "rate0")


def _excess(got, want, rtol=1e-4, atol=1e-5):
    return ((got - want).abs() - (atol + rtol * want.abs())).max().item()


@pytest.mark.parametrize("route", F32_ROUTES)
def test_encoder_train_f32_kernels_match_plain(cuda_device, route):
    """K6 and K7 with f32 operands against their plain versions at ragged
    lengths with an empty bag and a partial last tile (t = 300), row offset
    2, the real rates (rate0: 0): K6's pooled, tokens and valid logits
    within rtol 1e-4 / atol 1e-5, every K7 gradient (and dx at d_in 544)
    within 1e-4 relative Frobenius, bc within 1e-4 absolutely; two launches
    bitwise equal; the recompute route (K6 without saves, K7 rebuilding the
    residuals) bit for bit the save route; n_views = 3; the f32 route
    counters move, the bf16 ones do not."""
    from madeleine_torch.models.madeleine import half_split, train_weights
    from madeleine_torch.ops import encoder_train as et

    need_dx = route == "dx"
    rates = (0.0, 0.0) if route == "rate0" else (0.1, 0.25)
    cfg = MadeleineConfig(precision="float32", add_stain_encoding=need_dx).finalize()
    model = init_madeleine(MADELEINE(cfg), torch.Generator().manual_seed(0)).to(cuda_device)
    with torch.no_grad():
        w = {k: v.detach().contiguous() for k, v in train_weights(model, torch.float32).items()}
    d_in = w["w1"].shape[1]
    g = torch.Generator().manual_seed(9)
    x = torch.randn(3, 300, d_in, generator=g).to(cuda_device)
    mask = (torch.arange(300)[None, :] < torch.tensor([[300], [77], [0]])).to(cuda_device)
    bias = et.token_mask_bias(mask, 3, 300, cuda_device)
    vb = et.view_bias(half_split(4, 300, cuda_device), 300, cuda_device) if route == "views" \
        else None
    counts = (et.fwd_launches, et.bwd_launches, et.fwd_f32_launches, et.bwd_f32_launches)
    fa = (x, bias, w, 5, 2, *rates)
    got = et.encoder_train_fwd_cuda(*fa, vb=vb)
    assert all(torch.equal(a, b) for a, b in zip(got[:5], et.encoder_train_fwd_cuda(*fa, vb=vb)))
    with torch.no_grad():
        want = et.encoder_train_fwd_plain(*fa, vb=vb)
    assert got[3].dtype == torch.float32 and got[5]["u1"].dtype == torch.float32
    for i in (0, 3):
        assert _excess(got[i], want[i]) <= 0
    assert _excess(got[4][bias == 0], want[4][bias == 0]) <= 0
    assert (got[0][2] == 0).all()
    pooled32, m, s, _, l, saved = got
    gp = torch.randn(pooled32.shape, generator=g).to(cuda_device)
    dtok = torch.randn(3, 300, 128, generator=g).to(cuda_device)
    inner = (gp * pooled32).reshape(*pooled32.shape[:-1], 4, -1).sum(-1)
    args = [x, l, m, s, gp, inner, dtok, saved, w, 5, 2, *rates]
    gk = et.encoder_train_bwd_cuda(*args, need_dx=need_dx, vb=vb)
    assert all(torch.equal(gk[k], v) for k, v in
               et.encoder_train_bwd_cuda(*args, need_dx=need_dx, vb=vb).items())
    with torch.no_grad():
        plain = et.encoder_train_bwd_plain(*args, need_dx=need_dx, vb=vb)
    assert set(gk) == set(plain) and ("x" in gk) == need_dx
    for k in gk:
        if k == "bc":
            assert (gk[k] - plain[k]).abs().max().item() <= 1e-4
        else:
            assert _rel(gk[k], plain[k]) <= 1e-4, k
    if route == "recompute":
        nosave = et.encoder_train_fwd_cuda(*fa, save=False)
        assert nosave[5] is None and all(torch.equal(a, b) for a, b in zip(got[:5], nosave[:5]))
        args[7] = None
        before = et.bwd_f32_recompute_launches
        gr = et.encoder_train_bwd_cuda(*args)
        assert et.bwd_f32_recompute_launches == before + 1
        assert all(torch.equal(gr[k], gk[k]) for k in gk)
    after = (et.fwd_launches, et.bwd_launches, et.fwd_f32_launches, et.bwd_f32_launches)
    assert after[:2] == counts[:2] and after[2] > counts[2] and after[3] > counts[3]


def test_encoder_train_refuses_a_mixed_operand_set(cuda_device):
    """bf16 x with f32 weights, or f32 x with one bf16 matrix, raises a
    ValueError naming the operand on the card too."""
    from madeleine_torch.models.madeleine import train_weights
    from madeleine_torch.ops import encoder_train as et

    model = _model(cuda_device)
    with torch.no_grad():
        w = {k: v.detach().contiguous() for k, v in train_weights(model, torch.float32).items()}
    x = torch.randn(2, 64, 512, device=cuda_device)
    bias = et.token_mask_bias(None, 2, 64, cuda_device)
    with pytest.raises(ValueError, match="w1"):
        et.encoder_train_fwd_cuda(x.to(torch.bfloat16), bias, w, 1)
    with pytest.raises(ValueError, match="wt"):
        et.encoder_train_fwd_cuda(x, bias, dict(w, wt=w["wt"].to(torch.bfloat16)), 1)


def test_hbm_guard_sends_a_call_to_recompute_before_the_card_fills(cuda_device):
    """The save_acts gate with `_device_hbm_limit` unmocked: ballast that
    leaves the free plus reserved-but-unallocated bytes 256 MiB under a
    [8, 2048] call's saves + 4 x_bytes + 2 GiB makes the gate answer
    recompute and the autograd call take K6's save-off and K7's recompute
    routes; the ballast freed without emptying the cache (the card's free
    bytes still low) is counted again, and the call takes the save route."""
    from madeleine_torch.ops import encoder_train as et

    cfg = MadeleineConfig(precision="bfloat16").finalize()
    model = init_madeleine(MADELEINE(cfg), torch.Generator().manual_seed(0)).to(cuda_device)
    w = _train_operands(model)
    b, t = 8, 2048
    nh, f, e = w["wa"].shape
    h, d_in = w["w1"].shape
    x = torch.randn(b, t, d_in, generator=torch.Generator().manual_seed(2))
    x = x.to(cuda_device, torch.bfloat16)
    mask = (torch.arange(t)[None, :] < torch.arange(1, b + 1)[:, None] * 250).to(cuda_device)
    x_bytes = x.numel() * 2
    gate = (b, t, h, nh * e, 2 * nh * f, 2, x_bytes, x.device)
    need = b * t * ((2 * h + nh * e + 2 * nh * f) * 2 + 12) + 4 * x_bytes + et.GUARD_MARGIN

    def routes():
        before = (et.fwd_nosave_launches, et.bwd_recompute_launches)
        p, tok = et.encoder_train(x, mask, {k: v.detach().requires_grad_(True)
                                            for k, v in w.items()}, 5)
        (p.float().sum() + tok.float().sum()).backward()
        return (et.fwd_nosave_launches - before[0], et.bwd_recompute_launches - before[1])

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    lim0 = et._device_hbm_limit(cuda_device)
    nbytes = (lim0 - need + (256 << 20)) // (2 << 20) * (2 << 20)
    ballast = torch.empty(nbytes, dtype=torch.uint8, device=cuda_device)
    lim1 = et._device_hbm_limit(cuda_device)
    assert abs(lim0 - nbytes - lim1) <= 64 << 20 and lim1 < need
    assert not et.resolve_save_acts(None, *gate)
    assert routes() == (1, 1)
    del ballast
    torch.cuda.synchronize()
    assert torch.cuda.mem_get_info(cuda_device)[0] < need
    assert et._device_hbm_limit(cuda_device) >= need
    assert et.resolve_save_acts(None, *gate)
    assert routes() == (0, 0)
    torch.cuda.empty_cache()


def test_masked_subsample_on_the_card_equals_the_cpu(cuda_device):
    """The GOT draw of a ragged step: masked_subsample on the card with the
    same noise equals the CPU call, bags longer and shorter than the draw and
    an empty one; the noise drawn on the card is the CPU's but for the last
    bits of log (rtol 1e-6)."""
    from madeleine_torch.ops import losses as L
    from madeleine_torch.train.trainer import got_gumbel

    gen = torch.Generator().manual_seed(3)
    x = torch.randn(4, 500, 16, generator=gen)
    mask = torch.arange(500)[None, :] < torch.tensor([[500], [300], [40], [0]])
    noise = got_gumbel(11, 3, 4, 500, "cpu")
    torch.testing.assert_close(got_gumbel(11, 3, 4, 500, cuda_device).cpu(), noise,
                               rtol=1e-6, atol=1e-6)
    want = L.masked_subsample(x, mask, 256, noise[0, 0])
    got = L.masked_subsample(x.to(cuda_device), mask.to(cuda_device), 256,
                             noise[0, 0].to(cuda_device))
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("rates", [(0.0, 0.0), (0.1, 0.25)])
def test_per_op_kernels_match_plain(cuda_device, rates):
    """Kernels 15-20 (preattn, gated_logits, linear_tok, forward and
    backward) against their plain versions at 3 x 300 tokens (partial last
    tiles), row offset 4, dx included: outputs at atol 3e-2 (a bf16 output:
    or one bf16 rounding step of its value, where larger), gradients at
    1e-2 relative Frobenius; each backward twice gives bitwise-equal
    results."""
    from madeleine_torch.ops import gated_logits as gl
    from madeleine_torch.ops import linear_tok as lt
    from madeleine_torch.ops import preattn as pa

    w = _train_operands(_model(cuda_device))
    x, _ = _bags(cuda_device, [300, 300, 300], 300, torch.bfloat16)
    gen = torch.Generator().manual_seed(4)
    def within(got, want):   # atol 3e-2, or one bf16 rounding step of a bf16 value
        want = want.float()
        bar = torch.ldexp(torch.ones_like(want), torch.frexp(want).exponent - 8).clamp_min(3e-2)
        return bool(((got.float() - want).abs() <= bar).all())

    y = pa.preattn_fwd_cuda(x, w, 5, 4, rates[0])
    with torch.no_grad():
        assert within(y, pa.preattn_fwd_plain(x, w, 5, 4, rates[0]))
        logits = gl.gated_logits_fwd_cuda(y, w, 5, 4, rates[1])
        assert (logits - gl.gated_logits_fwd_plain(y, w, 5, 4, rates[1])).abs().max() <= 3e-2
        tok = lt.linear_tok_fwd_cuda(y, w["wt"], w["bt"])
        assert within(tok, lt.linear_tok_fwd_plain(y, w["wt"], w["bt"]))
    dy = torch.randn(*y.shape, generator=gen).to(cuda_device, torch.bfloat16)
    dl = torch.randn(*logits.shape, generator=gen).to(cuda_device)
    g = torch.randn(*tok.shape, generator=gen).to(cuda_device, torch.bfloat16)
    for kern, plain, args, kw in (
            (pa.preattn_bwd_cuda, pa.preattn_bwd_plain, (x, dy, w, 5, 4, rates[0]),
             {"need_dx": True}),
            (gl.gated_logits_bwd_cuda, gl.gated_logits_bwd_plain, (y, dl, w, 5, 4, rates[1]), {}),
            (lt.linear_tok_bwd_cuda, lt.linear_tok_bwd_plain, (y, g, w["wt"]), {})):
        got, again = kern(*args, **kw), kern(*args, **kw)
        with torch.no_grad():
            want = plain(*args, **kw)
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], again[k]), k
            err = ((got[k].float() - want[k].float()).norm() / want[k].float().norm()).item()
            assert err <= 1e-2, (kern.__name__, k, err)


@pytest.mark.parametrize("rates", [(0.0, 0.0), (0.1, 0.25)])
def test_per_op_forwards_match_plain_and_their_first_designs(cuda_device, rates):
    """Kernels 15 and 17 (the wgmma GEMM: preattn's rows on the warp-per-row
    kernel, the gate logits in the gate product's epilogue) and their first
    designs (`preattn_fwd_rowblock_cuda`, `gated_logits_fwd_rowblock_cuda`)
    against the plain versions at 3 x 300 tokens (partial last tiles), row
    offset 4, and against each other: atol 3e-2, or one bf16 rounding step
    of a bf16 value where larger. Each design twice gives bitwise-equal
    results and moves only its own counter."""
    from madeleine_torch.ops import gated_logits as gl
    from madeleine_torch.ops import preattn as pa

    w = _train_operands(_model(cuda_device))
    x, _ = _bags(cuda_device, [300, 300, 300], 300, torch.bfloat16)

    def within(got, want):   # atol 3e-2, or one bf16 rounding step of a bf16 value
        want = want.float()
        bar = (torch.ldexp(torch.ones_like(want), torch.frexp(want).exponent - 8).clamp_min(3e-2)
               if got.dtype == torch.bfloat16 else 3e-2)
        return bool(((got.float() - want).abs() <= bar).all())

    y = pa.preattn_fwd_cuda(x, w, 5, 4, rates[0])
    for mod, new, first, args in (
            (pa, pa.preattn_fwd_cuda, pa.preattn_fwd_rowblock_cuda, (x, w, 5, 4, rates[0])),
            (gl, gl.gated_logits_fwd_cuda, gl.gated_logits_fwd_rowblock_cuda,
             (y, w, 5, 4, rates[1]))):
        with torch.no_grad():
            want = (pa.preattn_fwd_plain if mod is pa else gl.gated_logits_fwd_plain)(*args)
        before = (mod.fwd_launches, mod.fwd_rowblock_launches)
        got, again = new(*args), new(*args)
        assert (mod.fwd_launches, mod.fwd_rowblock_launches) == (before[0] + 2, before[1])
        ref, ref_again = first(*args), first(*args)
        assert (mod.fwd_launches, mod.fwd_rowblock_launches) == (before[0] + 2, before[1] + 2)
        assert torch.equal(got, again) and torch.equal(ref, ref_again), new.__name__
        assert got.dtype == (torch.float32 if mod is gl else torch.bfloat16)
        assert within(got, want) and within(ref, want) and within(got, ref), new.__name__


def test_sigmoid_train_step_launches_the_per_op_kernels(cuda_device):
    """A bf16 InfoNCE + GOT step with activation sigmoid launches kernels
    15-20 (one forward and one backward of each per modality; GOT reads the
    tokens, so the token projector has a backward) and not K6/K7."""
    from madeleine_torch.ops import launches
    from madeleine_torch.train.optim import make_optimizer
    from madeleine_torch.train.trainer import make_train_step

    cfg = MadeleineConfig(precision="bfloat16", activation="sigmoid", local_loss="got",
                          got_subsample=128, temperature=0.1, warmup=False,
                          max_epochs=2).finalize()
    model = init_madeleine(MADELEINE(cfg), torch.Generator().manual_seed(0)).to(cuda_device)
    opt, sched = make_optimizer(cfg, model.parameters(), steps_per_epoch=2)
    step = make_train_step(cfg, model, opt, sched)
    gen = torch.Generator().manual_seed(1)
    batch = {"feats": torch.randn(4, 5, 256, 512, generator=gen),
             "modality_labels": torch.ones(4, 5), "sample_mask": torch.ones(4, dtype=torch.bool)}
    launches.reset()
    _, metrics = step(batch, seed=3)
    counts = launches.read()
    assert not metrics["skipped"] and torch.isfinite(metrics["loss"])
    for k in ("preattn_fwd", "preattn_bwd", "gated_logits_fwd", "gated_logits_bwd",
              "linear_tok_fwd", "linear_tok_bwd"):   # the forward ones twice: cfg.remat
        assert counts[k] == (10 if k.endswith("_fwd") else 5), (k, counts[k])
    assert counts["encoder_train_fwd"] == counts["encoder_train_bwd"] == 0


@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 3e-2), (torch.float32, 1e-5)],
                         ids=["bf16", "f32"])
def test_train_pool_kernels_match_plain(cuda_device, dtype, atol):
    """Rows 4 and 5 (the training pool and its backward) against their plain
    versions at t = 1000 (a partial last tile), ragged bags and an empty
    one: pooled as K3's bar, m exact, s rtol 1e-5, dx and dl at 1e-2
    relative Frobenius; the weights exp(l - m) / s sum to 1 over each live
    bag; the empty bag's pooled output, dx and dl are 0; two launches of
    each bitwise equal."""
    from madeleine_torch.ops import attn_pool as ap

    g = torch.Generator().manual_seed(7)
    b, t, nh, e = 3, 1000, 4, 512
    y = torch.randn(b, t, nh * e, generator=g).to(cuda_device, dtype)
    mask = (torch.arange(t)[None, :] < torch.tensor([[1000], [333], [0]])).to(cuda_device)
    l = (4.0 * torch.randn(b, t, nh, generator=g)).to(cuda_device)
    l = l.masked_fill(~mask[..., None], ap.NEG_INF).contiguous()
    before = (ap.pool_ms_launches, ap.pool_bwd_launches)
    pooled, m, s = ap.pool_ms_cuda(y, l)
    again = ap.pool_ms_cuda(y, l)
    assert all(torch.equal(u, v) for u, v in zip((pooled, m, s), again))
    wp, wm, ws = ap.pool_ms_plain(y, l)
    torch.testing.assert_close(pooled.float(), wp.float(), rtol=0 if dtype != torch.float32
                               else 1e-4, atol=atol)
    assert torch.equal(m, wm) and (pooled[2] == 0).all()
    torch.testing.assert_close(s, ws, rtol=1e-5, atol=0)
    a = ap.pool_weights(l, m, s).sum(1)
    torch.testing.assert_close(a[:2], torch.ones_like(a[:2]), rtol=1e-5, atol=0)
    gp = torch.randn(b, nh * e, generator=g).to(cuda_device)
    inner = (gp * pooled.float()).reshape(b, nh, e).sum(-1)
    dx, dl = ap.pool_bwd_cuda(y, l, m, s, gp, inner)
    dx2, dl2 = ap.pool_bwd_cuda(y, l, m, s, gp, inner)
    assert torch.equal(dx, dx2) and torch.equal(dl, dl2) and dx.dtype == dtype
    assert (ap.pool_ms_launches, ap.pool_bwd_launches) == (before[0] + 2, before[1] + 2)
    wdx, wdl = ap.pool_bwd_plain(y, l, m, s, gp, inner)
    assert (dx[2] == 0).all() and (dl[2] == 0).all() and torch.isfinite(dl).all()
    assert _rel(dx.float(), wdx.float()) <= 1e-2 and _rel(dl, wdl) <= 1e-2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_dropout_kernel_matches_plain_bit_for_bit(cuda_device, dtype):
    """Row 21 against `dropout_plain` bit for bit at [4096, 512] and at an
    odd [37, 21] (element loads), row offset 5, site 1; the backward's mask
    equals the forward's."""
    from madeleine_torch.ops import dropout as dp

    g = torch.Generator().manual_seed(8)
    for shape in ((4096, 512), (37, 21)):
        x = torch.randn(*shape, generator=g).to(cuda_device, dtype)
        before = dp.launches
        got = dp.dropout_cuda(x, 9, 0.2, 5, 1)
        assert dp.launches == before + 1
        assert torch.equal(got, dp.dropout_plain(x, 9, 0.2, 5, 1))
        xr = x.clone().requires_grad_(True)
        out = dp.dropout(xr, 0.2, 9, row_offset=5, site=1)
        out.backward(torch.ones_like(out))
        assert torch.equal(xr.grad, dp.dropout_plain(torch.ones_like(x), 9, 0.2, 5, 1))


def test_nofused_softmax_step_launches_the_training_pool(cuda_device, monkeypatch):
    """With MADELEINE_NO_FUSED_ENCODER set, a bf16 softmax InfoNCE + GOT step
    launches rows 4 and 5 and kernels 15-20 once per modality and
    direction, and not K6/K7."""
    from madeleine_torch.ops import launches
    from madeleine_torch.train.optim import make_optimizer
    from madeleine_torch.train.trainer import make_train_step

    monkeypatch.setenv("MADELEINE_NO_FUSED_ENCODER", "1")
    cfg = MadeleineConfig(precision="bfloat16", local_loss="got", got_subsample=128,
                          temperature=0.1, warmup=False, max_epochs=2).finalize()
    model = init_madeleine(MADELEINE(cfg), torch.Generator().manual_seed(0)).to(cuda_device)
    opt, sched = make_optimizer(cfg, model.parameters(), steps_per_epoch=2)
    step = make_train_step(cfg, model, opt, sched)
    gen = torch.Generator().manual_seed(1)
    batch = {"feats": torch.randn(4, 5, 256, 512, generator=gen),
             "modality_labels": torch.ones(4, 5), "sample_mask": torch.ones(4, dtype=torch.bool)}
    launches.reset()
    _, metrics = step(batch, seed=3)
    counts = launches.read()
    assert not metrics["skipped"] and torch.isfinite(metrics["loss"])
    for k in ("attn_pool_ms", "attn_pool_bwd", "preattn_fwd", "preattn_bwd", "gated_logits_fwd",
              "gated_logits_bwd", "linear_tok_fwd", "linear_tok_bwd"):   # forward: cfg.remat
        assert counts[k] == (10 if k.endswith(("_fwd", "_ms")) else 5), (k, counts[k])
    assert counts["encoder_train_fwd"] == counts["encoder_train_bwd"] == 0


@pytest.mark.parametrize("b,t,E,dout", [(3, 1000, 2048, 128), (3, 1000, 2048, 136),
                                         (2, 700, 2048, 256), (3, 1000, 544, 128)],
                         ids=["ragged_m", "dout136", "dout256", "e544"])
def test_linear_tok_forward_matches_plain(cuda_device, b, t, E, dout):
    """Kernel 19, the TMA + wgmma GEMM, against its plain version at a
    ragged M (3000 rows: a partial last 128-row tile), d_out 136 (a ragged
    second column tile), 256 (two tiles) and E 544 (a partial last k
    tile): atol 3e-2, or one bf16 rounding step of the value where larger;
    two launches bitwise equal; each launch counted once."""
    from madeleine_torch.ops import linear_tok as lt

    g = torch.Generator().manual_seed(9)
    y = torch.randn(b, t, E, generator=g).to(cuda_device, torch.bfloat16)
    wt = (torch.randn(dout, E, generator=g) / E ** 0.5).to(cuda_device, torch.bfloat16)
    bt = torch.randn(dout, generator=g).to(cuda_device)
    before = lt.fwd_launches
    got, again = lt.linear_tok_fwd_cuda(y, wt, bt), lt.linear_tok_fwd_cuda(y, wt, bt)
    assert lt.fwd_launches == before + 2
    assert torch.equal(got, again) and got.shape == (b, t, dout)
    want = lt.linear_tok_fwd_plain(y, wt, bt).float()
    bar = torch.ldexp(torch.ones_like(want), torch.frexp(want).exponent - 8).clamp_min(3e-2)
    assert bool(((got.float() - want).abs() <= bar).all())


def test_linear_tok_forward_refuses_a_misaligned_operand(cuda_device):
    """A y that starts 2 bytes past a 16-byte boundary (contiguous, so only
    its address is wrong) raises before any launch; so does a CPU wt."""
    from madeleine_torch.ops import linear_tok as lt

    E, dout = 256, 128
    buf = torch.zeros(2 * 64 * E + 1, device=cuda_device, dtype=torch.bfloat16)
    y = buf[1:].view(2, 64, E)
    wt = torch.zeros(dout, E, device=cuda_device, dtype=torch.bfloat16)
    bt = torch.zeros(dout, device=cuda_device)
    before = lt.fwd_launches
    with pytest.raises(ValueError, match="16-byte boundary"):
        lt.linear_tok_fwd_cuda(y, wt, bt)
    with pytest.raises(ValueError, match="linear_tok_fwd kernel"):
        lt.linear_tok_fwd_cuda(y.clone(), wt.cpu(), bt)
    assert lt.fwd_launches == before


@pytest.mark.parametrize("b,t,E,dout", [(3, 1000, 2048, 128), (3, 1000, 2048, 136),
                                         (2, 700, 2048, 256), (3, 1000, 544, 128)],
                         ids=["ragged_m", "dout136", "dout256", "e544"])
def test_linear_tok_backward_matches_plain_and_first_design(cuda_device, b, t, E, dout):
    """Kernel 20 on the TMA + wgmma GEMM against its plain version and its
    first design (the mma.sync GEMM) at a ragged M, d_out 136 (the dgrad's
    k and the weight gradient's rows not whole 64-wide tiles), 256 and E
    544: dy, dWt and dbt at 1e-2 relative Frobenius, dy also elementwise at
    atol 3e-2 or one bf16 rounding step where larger; two launches bitwise equal; each design on
    its own counter."""
    from madeleine_torch.ops import linear_tok as lt

    g = torch.Generator().manual_seed(11)
    y = torch.randn(b, t, E, generator=g).to(cuda_device, torch.bfloat16)
    gt = torch.randn(b, t, dout, generator=g).to(cuda_device, torch.bfloat16)
    wt = (torch.randn(dout, E, generator=g) / E ** 0.5).to(cuda_device, torch.bfloat16)
    before = (lt.bwd_launches, lt.bwd_mmasync_launches)
    got, again = lt.linear_tok_bwd_cuda(y, gt, wt), lt.linear_tok_bwd_cuda(y, gt, wt)
    first = lt.linear_tok_bwd_mmasync_cuda(y, gt, wt)
    assert (lt.bwd_launches, lt.bwd_mmasync_launches) == (before[0] + 2, before[1] + 1)
    want = lt.linear_tok_bwd_plain(y, gt, wt)
    for k in ("y", "wt", "bt"):
        assert torch.equal(got[k], again[k]), k
    for out in (got, first):
        assert out["y"].shape == y.shape and out["y"].dtype == torch.bfloat16
        ref = lt.tok_bwd_plain(y, gt, wt)[0]
        bar = torch.ldexp(torch.ones_like(ref), torch.frexp(ref).exponent - 8).clamp_min(3e-2)
        assert bool(((out["y"].float() - ref).abs() <= bar).all())
        for k in ("y", "wt", "bt"):
            rel = ((out[k].float() - want[k].float()).norm() / want[k].float().norm()).item()
            assert rel <= 1e-2, (k, rel)


def test_linear_tok_backward_refuses_a_misaligned_operand(cuda_device):
    """A g or y that starts 2 bytes past a 16-byte boundary raises before
    any launch, on both designs; so does an f32 y."""
    from madeleine_torch.ops import linear_tok as lt

    E, dout = 256, 128
    y = torch.zeros(2, 64, E, device=cuda_device, dtype=torch.bfloat16)
    gt = torch.zeros(2, 64, dout, device=cuda_device, dtype=torch.bfloat16)
    wt = torch.zeros(dout, E, device=cuda_device, dtype=torch.bfloat16)
    ybuf = torch.zeros(2 * 64 * E + 1, device=cuda_device, dtype=torch.bfloat16)
    gbuf = torch.zeros(2 * 64 * dout + 1, device=cuda_device, dtype=torch.bfloat16)
    before = (lt.bwd_launches, lt.bwd_mmasync_launches)
    for call in (lt.linear_tok_bwd_cuda, lt.linear_tok_bwd_mmasync_cuda):
        with pytest.raises(ValueError, match="16-byte boundary"):
            call(ybuf[1:].view(2, 64, E), gt, wt)
        with pytest.raises(ValueError, match="16-byte boundary"):
            call(y, gbuf[1:].view(2, 64, dout), wt)
        with pytest.raises(NotImplementedError, match="bf16"):
            call(y.float(), gt, wt)
    assert (lt.bwd_launches, lt.bwd_mmasync_launches) == before


# ---------------------------------------------------------------------------
# The TMA + wgmma GEMM (csrc/gemm_wgmma.cuh) at every layout K6/K7 use
# ---------------------------------------------------------------------------

def _operand_of(x, mn, off, z, rows, k):
    """Batch z's [rows, k] operand (f32) of a K-major or MN-major tensor."""
    if mn:
        return x[off[1] * z:off[1] * z + k, off[0] * z:off[0] * z + rows].float().T
    return x[off[0] * z:off[0] * z + rows, off[1] * z:off[1] * z + k].float()


def _rand(dev, *shape, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(*shape, generator=g) * scale).to(dev, torch.bfloat16)


# (name, a_mn, b_mn, M, N, K, batches, a_shape, a_off, b_shape, b_off, out dtype, beta,
#  act_split, bias): the shapes of K6/K7's products at a small token count
WGMMA_CASES = {
    "kk_ragged_m_f32_bias": (False, False, 3000, 544, 544, 1, (3000, 544), (0, 0), (544, 544),
                             (0, 0), torch.float32, False, -1, True),
    "kk_n136_bf16": (False, False, 1000, 136, 512, 1, (1000, 512), (0, 0), (136, 512), (0, 0),
                     torch.bfloat16, False, -1, True),
    "kmn_n544_beta": (False, True, 3000, 544, 512, 1, (3000, 512), (0, 0), (512, 544), (0, 0),
                      torch.float32, True, -1, False),
    "kmn_dx_n544_bf16": (False, True, 3000, 544, 512, 1, (3000, 512), (0, 0), (512, 544),
                         (0, 0), torch.bfloat16, False, -1, False),
    "kk_gate_products_batched": (False, False, 3000, 256, 128, 4, (3000, 512), (0, 128),
                                 (1024, 128), (256, 0), torch.float32, False, 128, True),
    "kmn_gate_dgrad_batched": (False, True, 3000, 128, 256, 4, (3000, 1024), (0, 256),
                               (1024, 128), (0, 256), torch.float32, True, -1, False),
}


@pytest.mark.parametrize("case", list(WGMMA_CASES))
def test_wgmma_gemm_matches_an_f32_product(cuda_device, case):
    """Each layout of the generalised GEMM against the f32 product of the
    same bf16 operands: f32 output within 1e-5 relative Frobenius (f32
    accumulation in another order), bf16 output within one bf16 rounding
    step of each value (or 1e-2 absolute); a ragged M (3000 rows), N = 136
    and 544, K = 544, beta = 1 (C += result), and per-head batches read by
    coordinates with K6's gate activations. Two launches are bitwise equal."""
    from madeleine_torch.ops import gemm as G

    (a_mn, b_mn, M, N, K, nb, a_shape, a_off, b_shape, b_off, dt, beta, act,
     has_bias) = WGMMA_CASES[case]
    a = _rand(cuda_device, *a_shape, seed=1)
    b = _rand(cuda_device, *b_shape, seed=2, scale=K ** -0.5)
    bias = (torch.randn(nb * N, generator=torch.Generator().manual_seed(3)).to(cuda_device)
            if has_bias else None)
    width = nb * N   # batch z's output columns start at z N
    c0 = (torch.randn(M, width, generator=torch.Generator().manual_seed(4)).to(cuda_device, dt)
          if beta else torch.zeros(M, width, device=cuda_device, dtype=dt))
    want = c0.float().clone()
    for z in range(nb):
        v = _operand_of(a, a_mn, a_off, z, M, K) @ _operand_of(b, b_mn, b_off, z, N, K).T
        if bias is not None:
            v = v + bias[z * N:(z + 1) * N]
        if act >= 0:
            v = torch.cat([torch.tanh(v[:, :act]), torch.sigmoid(v[:, act:])], dim=1)
        want[:, z * N:(z + 1) * N] = v + (want[:, z * N:(z + 1) * N] if beta else 0)
    outs = []
    for _ in range(2):
        c = c0.clone()
        G.wgmma_gemm(a, b, c, a_mn=a_mn, b_mn=b_mn, M=M, N=N, K=K, batches=nb, a_off=a_off,
                     b_off=b_off, ldc=width, stride_c=N, bias=bias, stride_bias=N, beta=beta,
                     act_split=act)
        outs.append(c)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    got = outs[0].float()
    if dt == torch.float32:
        assert _rel(got, want) <= 1e-5, _rel(got, want)
    else:
        bar = torch.ldexp(torch.ones_like(want), torch.frexp(want).exponent - 8).clamp_min(1e-2)
        assert bool(((got - want).abs() <= bar).all())


@pytest.mark.parametrize("nb,M,N,K", [(1, 512, 544, 20000), (4, 256, 128, 5000)],
                         ids=["dw1_d_in544", "dwab_batched"])
def test_wgmma_weight_gradient_split_k(cuda_device, nb, M, N, K):
    """The weight-gradient layout (both operands MN-major, token-major rows),
    split over the tokens into pieces summed in split order, against the f32
    product (1e-5 relative Frobenius); two launches bitwise equal."""
    from madeleine_torch.ops import gemm as G

    a = _rand(cuda_device, K, nb * M, seed=5)
    b = _rand(cuda_device, K, nb * N, seed=6)
    want = torch.stack([a[:, z * M:(z + 1) * M].float().T @ b[:, z * N:(z + 1) * N].float()
                        for z in range(nb)])
    outs = [G.wgmma_gemm(a, b, torch.empty(nb, M, N, device=cuda_device), a_mn=True, b_mn=True,
                         M=M, N=N, K=K, batches=nb, a_off=(M, 0), b_off=(N, 0), wgrad=True)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    assert _rel(outs[0], want) <= 1e-5, _rel(outs[0], want)


def test_wgmma_gemm_refuses_what_it_cannot_take(cuda_device):
    """A misaligned operand raises in the wrapper before any launch; a
    batched operand whose k tiles would run into the next batch (K not a
    multiple of 64 with a k offset) is refused by the launcher itself."""
    from madeleine_torch.ops import gemm as G

    buf = torch.zeros(64 * 256 + 8, device=cuda_device, dtype=torch.bfloat16)
    a = buf[1:1 + 64 * 256].view(64, 256)
    b = torch.zeros(128, 256, device=cuda_device, dtype=torch.bfloat16)
    c = torch.zeros(64, 128, device=cuda_device)
    before = G.launches
    with pytest.raises(ValueError, match="16-byte boundary"):
        G.wgmma_gemm(a, b, c, a_mn=False, b_mn=False, M=64, N=128, K=256)
    assert G.launches == before
    a2 = torch.zeros(64, 192, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="cudaError"):
        G.wgmma_gemm(a2, b[:, :96].contiguous(), torch.zeros(64, 256, device=cuda_device),
                     a_mn=False, b_mn=False, M=64, N=128, K=96, batches=2, a_off=(0, 96),
                     b_off=(0, 0), ldc=256, stride_c=128)


# ---------------------------------------------------------------------------
# The split-TF32 GEMM (csrc/gemm_tf32.cuh) at the forms K6/K7 use with f32 operands
# ---------------------------------------------------------------------------

# (M, N, K, batches, a_shape, a_off, w_shape, transpose, beta, bias): the weights
# w as stored, [batches, N, K] (linear, the gates) or [batches, K, N] (dgrad:
# transposed by the split); batch z's A columns at z a_off[1]
TF32_CASES = {
    "linear_ragged_m_bias": (3000, 544, 544, 1, (3000, 544), (0, 0), (1, 544, 544), False,
                             False, True),
    "linear_k136": (1000, 136, 136, 1, (1000, 136), (0, 0), (1, 136, 136), False, False, True),
    "dgrad_n544_beta": (3000, 544, 512, 1, (3000, 512), (0, 0), (1, 512, 544), True, True,
                        False),
    "gates_batched": (3000, 256, 128, 4, (3000, 512), (0, 128), (4, 256, 128), False, False,
                      True),
    "gate_dgrad_batched": (3000, 128, 256, 4, (3000, 1024), (0, 256), (4, 256, 128), True,
                           True, False),
}
TF32_RTOL = 2e-6   # relative Frobenius against float64: three TF32 terms keep ~21 bits


@pytest.mark.parametrize("case", list(TF32_CASES))
def test_tf32_gemm_matches_a_float64_product(cuda_device, case):
    """Each form-K product of the split-TF32 GEMM (A K-major, the weights
    split once into TF32 hi and lo, as stored or transposed) against the
    float64 product of the same f32 operands within TF32_RTOL relative
    Frobenius: a ragged M, N = 136 and 544, K = 136 (no multiple of 32: the
    map ends at K), beta, bias, per-head batches by coordinates. Two
    launches bitwise equal; the split pair adds up to the weights within
    2^-22 of each."""
    from madeleine_torch.ops import gemm as G

    M, N, K, nb, a_shape, a_off, w_shape, tr, beta, has_bias = TF32_CASES[case]
    g = torch.Generator().manual_seed(11)
    a = torch.randn(*a_shape, generator=g).to(cuda_device)
    w = (torch.randn(*w_shape, generator=g) * K ** -0.5).to(cuda_device)
    bias = torch.randn(nb * N, generator=g).to(cuda_device) if has_bias else None
    width = nb * N
    c0 = (torch.randn(M, width, generator=g).to(cuda_device) if beta
          else torch.zeros(M, width, device=cuda_device))
    sp = G.tf32_split(w, transpose=tr)
    hi, lo = sp.chunk(2)
    wk = (w.transpose(1, 2) if tr else w).reshape(nb * N, K)
    gap = ((hi + lo).double() - wk.double()).abs()
    assert bool((gap <= 2.0 ** -22 * wk.double().abs()).all())
    want = c0.double().clone()
    for z in range(nb):
        v = a[:, a_off[1] * z:a_off[1] * z + K].double() @ wk[z * N:(z + 1) * N].double().T
        if bias is not None:
            v = v + bias[z * N:(z + 1) * N].double()
        want[:, z * N:(z + 1) * N] += v
    outs = []
    for _ in range(2):
        c = c0.clone()
        G.tf32_gemm(a, sp, c, M=M, N=N, K=K, batches=nb, a_off=a_off, b_off=(N, 0), ldc=width,
                    stride_c=N, bias=bias, stride_bias=N, beta=beta)
        outs.append(c)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    assert _rel(outs[0].double(), want) <= TF32_RTOL, _rel(outs[0].double(), want)


@pytest.mark.parametrize("nb,M,N,K", [(1, 512, 544, 20000), (4, 256, 128, 5000)],
                         ids=["dw1_d_in544", "dwab_batched"])
def test_tf32_weight_gradient_pieces(cuda_device, nb, M, N, K):
    """The split-TF32 weight gradient (both operands token-major, transposed
    and split in shared memory; the tokens cut into pieces of whole 32-token
    k tiles summed in piece order) against the float64 product within
    TF32_RTOL; two launches bitwise equal."""
    from madeleine_torch.ops import gemm as G

    g = torch.Generator().manual_seed(12)
    a = torch.randn(K, nb * M, generator=g).to(cuda_device)
    b = torch.randn(K, nb * N, generator=g).to(cuda_device)
    want = torch.stack([a[:, z * M:(z + 1) * M].double().T @ b[:, z * N:(z + 1) * N].double()
                        for z in range(nb)])
    outs = [G.tf32_wgrad(a, b, torch.empty(nb, M, N, device=cuda_device), M=M, N=N, K=K,
                         batches=nb) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    assert _rel(outs[0].double(), want) <= TF32_RTOL, _rel(outs[0].double(), want)


def test_tf32_gemm_refuses_what_it_cannot_take(cuda_device):
    """A misaligned operand raises in the wrapper before any launch; a
    batched A whose k tiles would run into the next batch (K = 80, no
    multiple of 32, with a k offset) is refused by the launcher itself (cudaErrorInvalidValue), and
    K6 with f32 operands refuses an x 4 bytes past a 16-byte boundary
    before it launches."""
    from madeleine_torch.ops import encoder_train as et
    from madeleine_torch.ops import gemm as G

    sp = G.tf32_split(torch.zeros(128, 96, device=cuda_device))
    buf = torch.zeros(64 * 96 + 4, device=cuda_device)
    before = G.tf32_launches
    with pytest.raises(ValueError, match="16-byte boundary"):
        G.tf32_gemm(buf[1:1 + 64 * 96].view(64, 96), sp, torch.zeros(64, 128, device=cuda_device),
                    M=64, N=128, K=96)
    assert G.tf32_launches == before
    sp2 = G.tf32_split(torch.zeros(2, 128, 80, device=cuda_device))
    with pytest.raises(RuntimeError, match="cudaError"):
        G.tf32_gemm(torch.zeros(64, 160, device=cuda_device), sp2,
                    torch.zeros(64, 256, device=cuda_device), M=64, N=128, K=80, batches=2,
                    a_off=(0, 80), b_off=(128, 0), ldc=256, stride_c=128)
    from madeleine_torch.models.madeleine import train_weights

    with torch.no_grad():
        w = {k: v.detach().contiguous()
             for k, v in train_weights(_model(cuda_device, "float32"), torch.float32).items()}
    xb = torch.zeros(2 * 64 * 512 + 1, device=cuda_device)
    bias = et.token_mask_bias(None, 2, 64, cuda_device)
    before = et.fwd_f32_launches
    with pytest.raises(ValueError, match="16-byte boundary"):
        et.encoder_train_fwd_cuda(xb[1:].view(2, 64, 512), bias, w, 5, 0)
    assert et.fwd_f32_launches == before


def test_f32_slide_projection_is_the_same_at_any_batch_size(cuda_device):
    """ROADMAP C2 on the card: the f32 slide projector gives 64 pooled rows
    bit for bit the values of their two halves (two data-parallel ranks),
    within 1e-6 of the f32 product, where cuBLAS's f32 product of the halves
    differs from the whole batch's."""
    from madeleine_torch.models import madeleine as port

    model = _model(cuda_device, "float32")
    emb = model.wsi_embedders
    pooled = torch.randn(64, emb.n_heads, emb.hidden_dim,
                         generator=torch.Generator().manual_seed(3)).to(cuda_device)
    with torch.no_grad():
        whole = port._slide_projection(model, pooled, torch.float32)
        halves = torch.cat([port._slide_projection(model, p, torch.float32)
                            for p in (pooled[:32], pooled[32:])])
        f32 = port._linear_head_major(model, model.projector, pooled, torch.float32)
    assert torch.equal(whole, halves)
    assert _rel(whole, f32) <= 1e-6


@pytest.mark.parametrize("d_in,need_dx", [(512, False), (544, True)], ids=["t4057", "d_in544_dx"])
def test_encoder_train_kernels_match_plain_at_a_partial_tile(cuda_device, d_in, need_dx):
    """K6 and K7 on the wgmma GEMM at t = 4057 (63 full 64-row tiles and 25
    rows), rates (0.1, 0.25), against their plain versions at the bars of
    test_encoder_train_kernels_match_plain; at d_in 544 with dx (the
    stain-encoded call). Two launches of each bitwise equal."""
    from madeleine_torch.ops import encoder_train as et

    cfg = MadeleineConfig(precision="bfloat16", add_stain_encoding=d_in == 544).finalize()
    model = init_madeleine(MADELEINE(cfg), torch.Generator().manual_seed(0)).to(cuda_device)
    w = _train_operands(model)
    g = torch.Generator().manual_seed(8)
    t = 4057
    x = torch.randn(2, t, d_in, generator=g).to(cuda_device, torch.bfloat16)
    mask = torch.ones(2, t, dtype=torch.bool)
    mask[0, :4000] = False
    bias = et.token_mask_bias(mask.to(cuda_device), 2, t, cuda_device)
    rates = (0.1, 0.25)
    got = et.encoder_train_fwd_cuda(x, bias, w, 5, 1, *rates)
    again = et.encoder_train_fwd_cuda(x, bias, w, 5, 1, *rates)
    with torch.no_grad():
        want = et.encoder_train_fwd_plain(x, bias, w, 5, 1, *rates)
    assert all(torch.equal(u, v) for u, v in zip(got[:5], again[:5]))
    assert (got[0] - want[0]).abs().max().item() <= 2e-3
    assert (got[3].float() - want[3].float()).abs().max().item() <= 3e-2
    assert (got[4] - want[4]).abs()[bias == 0].max().item() <= 3e-2
    pooled32, m, s, _, l, saved = got
    gp = torch.randn(2, pooled32.shape[1], generator=g).to(cuda_device)
    dtok = torch.randn(2, t, 128, generator=g).to(cuda_device, torch.bfloat16)
    inner = (gp * pooled32).reshape(2, 4, -1).sum(-1)
    args = (x, l, m, s, gp, inner, dtok, saved, w, 5, 1, *rates)
    gk = et.encoder_train_bwd_cuda(*args, need_dx=need_dx)
    gk2 = et.encoder_train_bwd_cuda(*args, need_dx=need_dx)
    with torch.no_grad():
        ref = et.encoder_train_bwd_plain(*args, need_dx=need_dx)
    keys = et.W_KEYS + (("x",) if need_dx else ())
    for k in keys:
        assert torch.equal(gk[k], gk2[k]), k
        if k == "bc":
            assert (gk[k] - ref[k]).abs().max().item() <= 1e-4
        else:
            assert _rel(gk[k].float(), ref[k].float()) <= 1e-2, k


def test_encoder_train_refuses_a_misaligned_input(cuda_device):
    """An x that starts 2 bytes past a 16-byte boundary raises before K6
    launches."""
    from madeleine_torch.ops import encoder_train as et

    w = _train_operands(_model(cuda_device))
    buf = torch.zeros(2 * 64 * 512 + 1, device=cuda_device, dtype=torch.bfloat16)
    x = buf[1:].view(2, 64, 512)
    bias = et.token_mask_bias(None, 2, 64, cuda_device)
    before = et.fwd_launches
    with pytest.raises(ValueError, match="16-byte boundary"):
        et.encoder_train_fwd_cuda(x, bias, w, 5, 0)
    assert et.fwd_launches == before


# ---------------------------------------------------------------------------
# the native .bag loader's pinned ring
# ---------------------------------------------------------------------------

def _native_cohort(root, n_cases, d=64):
    """<root>/bags/case{i}_{stain}.bag (f32; HE always, the rest at random,
    36-299 rows) and <root>/cohort.csv; returns (csv path, bag dir)."""
    import csv
    import os

    from madeleine_torch.config import MODALITY_DICTS
    from madeleine_torch.native.bagio import write_bag_file

    stains = MODALITY_DICTS["ACROBAT"]
    rng = np.random.default_rng(11)
    bags = os.path.join(root, "bags")
    os.makedirs(bags)
    rows = []
    for i in range(n_cases):
        labels = {s: int(s == "HE" or rng.random() < 0.8) for s in stains}
        for s, present in labels.items():
            if present:
                write_bag_file(os.path.join(bags, f"case{i}_{s}.bag"),
                               rng.standard_normal((int(rng.integers(36, 300)), d),
                                                   dtype=np.float32))
        rows.append({"slide_id": f"case{i}", **labels, "split": "train"})
    with open(os.path.join(root, "cohort.csv"), "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    return os.path.join(root, "cohort.csv"), bags, stains


@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
def test_native_loader_pinned_ring_matches_plain(cuda_device, tmp_path, out_dtype):
    """For the card the ring is pinned, 4 slots deep (small slots, the
    default buffer_depth); its batches (host library, built here with
    -march=native) equal the plain route's bit for bit, and survive the
    copy to the card unchanged; each batch's copy is recorded."""
    from madeleine_torch.native.dataset import NativeTrainLoader, SlotGuard

    csv_path, bags, stains = _native_cohort(str(tmp_path), 13)
    kw = dict(embedding_size=64, sample=128, batch_size=4, seed=2, out_dtype=out_dtype)
    ours = NativeTrainLoader(csv_path, bags, stains, device=cuda_device, **kw)
    plain = NativeTrainLoader(csv_path, bags, stains, device="cpu", plain=True, **kw)
    assert ours.ring_depth == 4 and plain.ring_depth == 4
    as_bits = torch.int16 if out_dtype == "bfloat16" else torch.float32
    for got, want in zip(ours, plain):
        assert got["feats"].is_pinned() and not want["feats"].is_pinned()
        dev = got["feats"].to(cuda_device, non_blocking=True)
        assert isinstance(got["copied"], SlotGuard)
        got["copied"].record()
        assert torch.equal(got["feats"].view(as_bits), want["feats"].view(as_bits))
        assert torch.equal(dev.cpu().view(as_bits), want["feats"].view(as_bits))


def test_native_ragged_ring_refills_a_slot_after_its_copy(cuda_device, tmp_path):
    """NativeRaggedLoader, a ring of 2 pinned slots, batches of buckets 64,
    64 and 256: batch 2 refills slot 0 only after batch 0's copy, queued
    behind about 0.3 s of device sleep, has completed (the guard's wait),
    the copy that landed is batch 0's, and every batch equals the plain
    route's bit for bit; both slots are sized at construction for bucket
    256, the cohort's largest, and never replaced, so the ring's pinned
    bytes are two such slots (ring_depth 2, buffer_depth's); every batch
    taken is recorded."""
    import csv
    import os

    from madeleine_torch.config import MODALITY_DICTS
    from madeleine_torch.native.bagio import write_bag_file
    from madeleine_torch.native.dataset import NativeRaggedLoader

    stains = MODALITY_DICTS["ACROBAT"]
    rng = np.random.default_rng(12)
    bags = os.path.join(str(tmp_path), "bags")
    os.makedirs(bags)
    rows = []
    for i in range(12):
        for s in stains:
            write_bag_file(os.path.join(bags, f"case{i}_{s}.bag"),
                           rng.standard_normal((40 if i < 8 else 250, 64), dtype=np.float32))
        rows.append({"slide_id": f"case{i}", **{s: 1 for s in stains}, "split": "train"})
    csv_path = os.path.join(str(tmp_path), "cohort.csv")
    with open(csv_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    kw = dict(embedding_size=64, batch_size=4, seed=3, buffer_depth=2, out_dtype="bfloat16",
              buckets=(64, 256), shuffle=False)
    loader = NativeRaggedLoader(csv_path, bags, stains, device=cuda_device, **kw)
    slots = [x.data_ptr() for x in loader._ring]
    assert loader.ring_depth == 2 and loader.pinned_bytes == 2 * 4 * 5 * 256 * 64 * 2
    plain = [b["feats"].clone() for b in NativeRaggedLoader(csv_path, bags, stains,
                                                             device="cpu", plain=True, **kw)]
    batches = iter(loader)
    b0 = next(batches)
    want = b0["feats"].clone()
    torch.cuda.synchronize()
    torch.cuda._sleep(600_000_000)
    dev = b0["feats"].to(cuda_device, non_blocking=True)
    b0["copied"].record()
    b1 = next(batches)
    b1["copied"].record()
    assert not b0["copied"].query()       # the copy is still queued
    b2 = next(batches)                    # slot 0 again, at bucket 256
    b2["copied"].record()
    assert b0["copied"].query()
    assert [b["feats"].shape[2] for b in (b0, b1, b2)] == [64, 64, 256]
    assert loader.timings[2]["guard_wait_ms"] > 50, loader.timings
    assert b2["feats"].is_pinned() and b2["feats"].data_ptr() == slots[0]
    assert [x.data_ptr() for x in loader._ring] == slots
    assert loader.pinned_bytes == 2 * 4 * 5 * 256 * 64 * 2
    torch.cuda.synchronize()
    assert torch.equal(dev.cpu().view(torch.int16), want.view(torch.int16))
    for got, ref in zip((b1, b2), plain[1:]):
        assert torch.equal(got["feats"].view(torch.int16), ref.view(torch.int16))


def test_native_loader_waits_for_the_slot_copy(cuda_device, tmp_path):
    """A ring of 2 slots (ring_depth 2, buffer_depth's): batch 0's copy is
    queued behind 6e8 cycles (about 0.3 s) of device sleep and its event
    recorded after it; batch 2 reuses slot 0, so the loader waits on that
    event before it assembles (the guard's wait shows it), and the copy that
    landed on the card is batch 0's; every batch taken is recorded."""
    from madeleine_torch.native.dataset import NativeTrainLoader

    csv_path, bags, stains = _native_cohort(str(tmp_path), 12)
    loader = NativeTrainLoader(csv_path, bags, stains, embedding_size=64, sample=128,
                               batch_size=4, seed=3, buffer_depth=2, out_dtype="bfloat16",
                               device=cuda_device)
    assert loader.ring_depth == 2
    batches = iter(loader)
    b0 = next(batches)
    want = b0["feats"].clone()
    torch.cuda.synchronize()
    torch.cuda._sleep(600_000_000)
    dev = b0["feats"].to(cuda_device, non_blocking=True)
    b0["copied"].record()
    next(batches)["copied"].record()
    assert not b0["copied"].query()       # the copy is still queued
    next(batches)["copied"].record()      # slot 0 again
    assert b0["copied"].query()
    assert loader.timings[2]["guard_wait_ms"] > 50, loader.timings
    assert loader.timings[1]["guard_wait_ms"] < 50, loader.timings
    torch.cuda.synchronize()
    assert torch.equal(dev.cpu().view(torch.int16), want.view(torch.int16))


def test_eval_views_launch_k3_for_each_view(cuda_device):
    """forward_train(train=False, n_views=3): K3 pools the whole bag and both
    half-bag views of every modality; the whole-bag view is n_views=1's."""
    from madeleine_torch.models.madeleine import forward_train
    from madeleine_torch.ops import attn_pool

    model = _model(cuda_device)
    feats = torch.randn(2, 5, 300, 512, generator=torch.Generator().manual_seed(2))
    feats = feats.to(cuda_device, torch.bfloat16)
    before = attn_pool.launches
    views, _ = forward_train(model, feats, train=False, n_views=3)
    assert attn_pool.launches - before == 15
    one, _ = forward_train(model, feats, train=False)
    assert torch.equal(views[:, :, :1], one)


def test_trace_records_gpu_ranges(cuda_device, tmp_path):
    """utils/profiling.py on the card: trace() takes CUDA activity, and
    module_device_ms reads an annotate() range's GPU span from its export."""
    from madeleine_torch.utils import profiling as P

    x = torch.randn(2048, 2048, device=cuda_device)
    with P.trace(str(tmp_path)):
        for _ in range(3):
            with P.annotate("port_matmul"):
                x @ x
        torch.cuda.synchronize()
    ms = P.module_device_ms(str(tmp_path), "port_matmul")
    assert ms is not None and ms > 0
    assert P.module_device_ms(str(tmp_path), "no_such_range") is None
