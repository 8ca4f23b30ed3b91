"""Tests of the port that need a CUDA device (marked `gpu`; they skip elsewhere).

This file imports neither JAX nor the JAX package, so it also runs on a GPU
machine without them:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

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


@pytest.mark.parametrize("wc_scale", [1.0, PEAK_WC_SCALE])
def test_encode_fused_kernel_matches_plain(cuda_device, wc_scale):
    """bf16, atol 3e-2 on the bf16 output; a partial last tile and an empty bag.
    At the init's scale the logits spread by well under one unit and the pool
    is nearly uniform; scaling wc spreads them by several units, so a kernel
    whose gates or logits were wrong would miss the bar. The control: the
    uniform pool (wc = 0) must differ from the peaked one by more than atol."""
    atol = 3e-2
    model = _model(cuda_device)
    w = ef.kernel_weights(encoder_weights(model.wsi_embedders), torch.bfloat16)
    w["wc"] = w["wc"] * wc_scale
    x, mask = _bags(cuda_device, [1000, 613, 0], 1000, torch.bfloat16)
    bias = mask_bias(mask, 3, 1000, 4, cuda_device)
    got = ef.encode_fused_cuda(x, bias, w)
    want = ef.encode_pool_fused_plain(x, bias, w)
    assert (got.float() - want.float()).abs().max().item() <= atol
    assert (got[2] == 0).all()
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
    torch.testing.assert_close(gp.gated_pool_cuda(y, bias, **w),
                               gp.gated_attention_pool_plain(y, bias, **w),
                               rtol=1e-4, atol=1e-5)


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


def test_train_step_launches_k6_k7_and_refuses_f32(cuda_device):
    """A bf16 step on the card goes through K6 and K7 (one each per
    modality); an f32 step on the card raises, naming the ROADMAP item."""
    import numpy as np

    from madeleine_torch.ops import encoder_train as et
    from madeleine_torch.train.optim import make_optimizer
    from madeleine_torch.train.trainer import make_train_step

    rng = np.random.default_rng(0)
    batch = {"feats": rng.standard_normal((4, 5, 256, 512)).astype(np.float32),
             "modality_labels": np.ones((4, 5), np.float32)}
    for precision in ("bfloat16", "float32"):
        cfg = MadeleineConfig(precision=precision, local_loss="-1").finalize()
        model = init_madeleine(MADELEINE(cfg), torch.Generator().manual_seed(0)).to(cuda_device)
        opt, sched = make_optimizer(cfg, model.parameters(), 10)
        step = make_train_step(cfg, model, opt, sched)
        if precision == "float32":
            with pytest.raises(NotImplementedError, match="ROADMAP.md D4"):
                step(batch, seed=1)
            continue
        f0, b0 = et.fwd_launches, et.bwd_launches
        _, metrics = step(batch, seed=1)
        assert not metrics["skipped"] and np.isfinite(float(metrics["loss"]))
        assert (et.fwd_launches - f0, et.bwd_launches - b0) == (5, 5)


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


@pytest.mark.parametrize("shape", [(7, 256, 192), (260, 256, 256)], ids=["odd", "step"])
def test_ipot_and_gw_kernels_match_plain(cuda_device, shape):
    """K8 at (beta, iters) = (0.5, 30) and (0.1, 20), K9 with the loss's
    cotangent C, K10 at (0.1, 5 x 20), each against its plain version:
    relative Frobenius 1e-4 for T and gamma, 1e-3 for dC; a second launch of
    each is bitwise equal."""
    from madeleine_torch.ops import ipot as I

    C, Cs, Ct, Cst = _got_costs(cuda_device, *shape)
    for beta, iters in ((0.5, 30), (0.1, 20)):
        T = I.ipot_plan_cuda(C, beta, iters)
        assert torch.equal(T, I.ipot_plan_cuda(C, beta, iters))
        assert _rel(T, I.ipot_plan_plain(C, beta, iters)) <= 1e-4, (beta, iters)
    dC = I.ipot_plan_bwd_cuda(C, C, 0.5, 30)
    assert torch.equal(dC, I.ipot_plan_bwd_cuda(C, C, 0.5, 30))
    assert _rel(dC, I.ipot_plan_bwd_plain(C, C, 0.5, 30)) <= 1e-3
    gamma = I.gw_gamma_cuda(Cs, Ct, Cst, 0.1, 5, 20)
    assert torch.equal(gamma, I.gw_gamma_cuda(Cs, Ct, Cst, 0.1, 5, 20))
    assert _rel(gamma, I.gw_gamma_plain(Cs, Ct, Cst, 0.1, 5, 20)) <= 1e-4


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
    K12's dthr and for K13/K14; a second launch of each is bitwise equal."""
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
    out = G.gw_trace_cuda(Cs, Ct, Cst, gamma)
    assert torch.equal(out, G.gw_trace_cuda(Cs, Ct, Cst, gamma))
    assert _rel(out, G.gw_trace_plain(Cs, Ct, Cst, gamma)) <= 1e-5
    dout = torch.randn(7, generator=g).to(cuda_device)
    grads = G.gw_trace_bwd_cuda(Cs, Ct, gamma, dout)
    again = G.gw_trace_bwd_cuda(Cs, Ct, gamma, dout)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    for got, want in zip(grads, G.gw_trace_bwd_plain(Cs, Ct, Cst, gamma, dout)):
        assert _rel(got, want) <= 1e-5


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
              "linear_tok_fwd", "linear_tok_bwd"):
        assert counts[k] == 5, (k, counts[k])
    assert counts["encoder_train_fwd"] == counts["encoder_train_bwd"] == 0
