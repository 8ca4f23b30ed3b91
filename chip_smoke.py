#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (`madeleine_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py                       # every phase (what CI runs)
    python3 chip_smoke.py --phases device,build,kernels
    python3 chip_smoke.py --phases device,build,train_kernels,train
    python3 chip_smoke.py --phases device,build,got_kernels,train_got
    python3 chip_smoke.py --phases device,build,glue_kernels,train_got,pretrain
    python3 chip_smoke.py --phases device,build,pool_kernels,golden,eval_forward
    python3 chip_smoke.py --phases device,build,perop_kernels,train_sigmoid

Phases, one JSON line each; any failure raises and the exit code is non-zero:
  device   card name and the nvidia-smi name/power-limit line
  build    nvcc build of every kernel under madeleine_torch/csrc, timed
  kernels  K1 (encode_fused, bf16) and K2 (gated_pool, f32) at the published
           widths, b=8, t=4096, ragged lengths (one bag empty), plus a
           t=4057 call whose last tile is partial: each held against its
           plain PyTorch version on the card, and timed with CUDA events.
           K1 is checked with the flagship weights and again with peaked
           attention (wc scaled), against a uniform-pool control
  pool_kernels
           K3 (attn_pool) in bf16 and f32 at the eval forward's call shape
           [65, 2048, 2048] (4 heads of 512) and at t = 2000 (a partial last
           tile), 32 bags full, 32 ragged and one empty, logits of the
           flagship's spread and peaked (x 16), each against its plain
           version (bf16: rtol 2e-2 plus 1% of each bag's largest output),
           with a uniform-pool control that must break the bar in every full
           bag; two launches bitwise equal; timed at [65, 2048, 2048] beside
           the library's call for the same function (scaled_dot_product_attention
           with zero q and k and the logits as its mask)
  perop_kernels
           kernels 15-20 of the per-op lane, bf16: preattn (15/16),
           gated_logits (17/18) and linear_tok (19/20), each against its plain
           version at dropout rates 0 and (0.1, 0.25), row offset 3, at the
           train step's call shape [65, 2048], at b=8, t=4096 and at b=2,
           t=4057 (partial last tiles), and preattn's dx at [65, 2048, 544]:
           outputs at atol 3e-2, gradients at 1e-2 relative Frobenius, two
           launches of each bitwise equal; then at (0.1, 0.25) the chain
           preattn -> gated_logits -> plain softmax pool -> linear_tok through
           autograd against K6/K7 on the same x, seed and rows (pooled 2e-3,
           tokens 3e-2, every weight gradient 1e-2, bc 1e-4 absolute): the
           masks line up. Timed at [65, 2048] beside their plain versions and,
           for linear_tok's forward, torch.nn.functional.linear
  golden   flagship weights saved as model.pt + model_config.json, loaded by
           create_model_from_pretrained; encode_he against
           tests/golden/golden_flagship.npz in f32 (through K2) and bf16 (K1);
           the eval forward forward_train(train=False) in f32 (K3) against
           fs/train/* and, with stain encodings, se/train/*; encode with stain
           codes 3 and 1 against se/eval/* through K2 (f32) and K1 at d_in 544
           (bf16)
  serve    EmbeddingService at bf16 behind the HTTP front: 16 ragged requests
           (300-9000 tokens), each equal to a direct encode; K1 must launch
  extract  the extraction CLI in-process at f32 over 16 .npz bags; K2 must launch
  eval_forward
           forward_train(train=False) at [65, 5, 2048, 512] bf16 with the
           flagship weights: K3 must launch once per modality; its slide and
           token embeddings of 4 cases against the f32 model's (relative
           Frobenius 2e-2); timed
  train_kernels
           K6 (encoder_train_fwd) and K7 (encoder_train_bwd), bf16: each
           against its plain version at dropout rates 0 and (0.1, 0.25) with
           identical masks, a random pooled cotangent and dtok, flagship and
           peaked weights (with the uniform-pool control), at b=8, t=4096
           ragged and at t=4057 with a bag valid only around its partial last
           tile (with a dropped-tile control); then at the train step's call
           shape [65, 2048] at the real rates, and at the stain-encoded
           step's [65, 2048, 544] with K7's input gradient dx (need_dx), whose
           stain columns summed in bf16 (the table's gradient) are held to
           their f32 sum. Both kernels run twice and must agree bitwise.
           Timed at b=8, t=4096, at [65, 2048] and at [65, 2048, 544] with dx
  got_kernels
           K8 (ipot_fwd), K9 (ipot_bwd) and K10 (gw_gamma), f32, on costs
           built as the GOT path builds them (random d=128 tokens ->
           cosine cost -> threshold-ReLU), at the train step's [260, 256,
           256] and at an odd (7, 256, 192): K8 at (beta, iters) (0.5, 30)
           and (0.1, 20), K9 with the loss's cotangent C, K10 at 5 x 20, each
           against its plain version (relative Frobenius bars below), with a
           control that must miss the bar: the plain version one iteration
           short (K10: the largest outer count below 5 that misses it); two
           launches of each bitwise equal; timed at [260, 256, 256]
  glue_kernels
           K11 (threshold_build forward), K12 (its backward), K13 (gw_trace
           forward) and K14 (its backward), f32, on cosine costs of random
           d=128 tokens with per-problem thresholds and the GW plan of K10, at
           [260, 256, 256] and (7, 256, 192), each against its plain version
           (relative Frobenius per output: 1e-6 for K11/K12, 1e-5 for K12's
           dthr and K13/K14), with a control that must miss the bar: the plain
           version fed the neighbouring problem's thresholds (K11/K12) or plan
           (K13/K14); two launches of each bitwise equal; timed at [260, 256, 256]
  train    5 steps of make_train_step at full width (65 cases x 5 stains x
           2048 tokens, bf16, InfoNCE, dropout on) on one fixed synthetic
           batch: no step skipped, finite losses, the last below the first;
           K6/K7 must launch on every step
  train_got
           the same 5 steps with the published objective, InfoNCE + GOT
           (local_loss got, weight 1, 256 tokens subsampled per stain pair:
           260 transport problems of 256 x 256 per step): K6-K14 must launch
           on every step; step ms, peak memory, the GOT share of the step and
           the GOT loss's device time split into glue kernels, transport
           kernels and the rest
  train_se the same 5 steps with stain encodings (--add_stain_encoding:
           d_in 544, K7's dx route): K6-K14 on every step, losses fall, no
           step skipped, the stain table moves; step ms and peak memory
  train_sigmoid
           the same 5 steps with --activation sigmoid (the per-op lane):
           kernels 15-20 and K8-K14 must launch on every step, K6/K7 on none;
           step ms and peak memory against train_got's, the plain sigmoid
           pool's own peak, and one profiled step (device idle share)
  pretrain `python -m madeleine_torch.cli.pretrain` with the flags of
           scripts/launch_pretrain_withoutStainEncodings.sh (65 cases x 5
           stains x 2048 tokens, bf16, InfoNCE + GOT) on a synthetic cohort
           of 70 cases (about 0.9 GB of .npz bags of 512-2560 tokens, 20% of
           IHC bags missing) in a temp dir: A 2 epochs with
           --checkpoint_every 1, B A resumed to 3 epochs, C 3 epochs
           straight, each with a 16-bag --downstream_dir. Every step finite
           and applied, K6-K14 on every step, K1 in each downstream pass, the
           artifacts written, B's model.pt equal to C's bit for bit; the
           loader's host ms per batch, the H2D ms of a batch, the CLI's step
           ms against train_got's, epoch time and peak memory; then the flags
           of scripts/launch_pretrain_withStainEncodings.sh: A' 1 epoch, B'
           A' resumed to 2, C' 2 straight, B' equal to C' bit for bit; then
           the first script's flags with --activation sigmoid, 1 epoch
           (kernels 15-20 and K8-K14 on every step)
  profile  torch.profiler device time by kernel of one K6 and one K7 call at
           [65, 2048], of one full-width train step of each objective and of
           one full-width eval forward, with their device idle share; each read from a second
           profiled window after a warm-up window (a first window can lose
           its kernels), the K6/K7 single windows reported beside them
Then a {"kernels": [...]} summary line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Needs CUDA and the repo checkout around it.
"""

from __future__ import annotations

import argparse
import importlib.util
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = ("device", "build", "kernels", "pool_kernels", "train_kernels", "got_kernels",
          "glue_kernels", "perop_kernels", "golden", "serve", "extract", "eval_forward", "train",
          "train_got", "train_se", "train_sigmoid", "pretrain", "profile")
# the runs of the port's main paths whose kernel launches the summary counts
MAIN_PATHS = ("serve", "extract", "eval_forward", "train", "train_got", "train_se",
              "train_sigmoid", "pretrain")
SEED = 0

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# K1 is also checked with wc scaled by this: the flagship init's attention
# logits spread by well under one unit, this spreads them by several
PEAK_WC_SCALE = 16.0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, warmup: int = 3, iters: int = 15) -> float:
    """Median time of one call in ms, CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def flagship_state_dict(stain_encoding: bool = False):
    """tests/golden/generate.py::flagship_state_dict, loaded by file path
    (pure numpy); sys.path and sys.modules are restored afterwards."""
    path = os.path.join(HERE, "tests", "golden", "generate.py")
    saved_path, saved_mods = list(sys.path), set(sys.modules)
    spec = importlib.util.spec_from_file_location("_golden_generate", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sys.path[:] = saved_path
    for name in set(sys.modules) - saved_mods:
        del sys.modules[name]
    return mod.flagship_state_dict(stain_encoding=stain_encoding)


def flagship_config(precision: str, stain_encoding: bool = False) -> dict:
    return {"wsi_encoder": "abmil", "patch_embedding_dim": 512,
            "wsi_encoder_hidden_dim": 512, "attention_hidden_dim": 512, "n_heads": 4,
            "activation": "softmax", "precision": precision, "dataset": "ACROBAT",
            "add_stain_encoding": stain_encoding}


def flagship_model(torch, precision: str, stain_encoding: bool = False):
    """The port model with the flagship weights, on the card, in eval mode."""
    from madeleine_torch.config import MadeleineConfig
    from madeleine_torch.models.madeleine import MADELEINE

    model = MADELEINE(MadeleineConfig.from_dict(flagship_config(precision, stain_encoding)))
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in flagship_state_dict(stain_encoding).items()})
    return model.cuda().eval()


def write_model_dir(root: str, precision: str, stain_encoding: bool = False) -> str:
    """<root>/MADELEINE/{model.pt, model_config.json} with the flagship weights."""
    import torch

    d = os.path.join(root, "MADELEINE")
    os.makedirs(d, exist_ok=True)
    torch.save({k: torch.from_numpy(v) for k, v in flagship_state_dict(stain_encoding).items()},
               os.path.join(d, "model.pt"))
    with open(os.path.join(d, "model_config.json"), "w") as f:
        json.dump(flagship_config(precision, stain_encoding), f)
    return d


def reset_counts():
    from madeleine_torch.ops import launches

    launches.reset()


def read_counts() -> dict:
    from madeleine_torch.ops import launches

    return launches.read()


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(state):
    import torch

    state["kind"] = torch.cuda.get_device_name(0)
    state["smi"] = nvidia_smi_line()
    emit({"phase": "device", "kind": state["kind"], "count": torch.cuda.device_count(),
          "nvidia_smi": state["smi"], "torch": torch.__version__,
          "cuda": torch.version.cuda})


def phase_build(state):
    from madeleine_torch.ops import _build

    t0 = time.perf_counter()
    reports = _build.build(force=True)
    secs = time.perf_counter() - t0
    ptxas = {n: [ln.strip() for ln in r.splitlines()
                 if "registers" in ln or "spill" in ln or "smem" in ln]
             for n, r in reports.items()}
    emit({"phase": "build", "seconds": secs, "built": sorted(reports), "ptxas": ptxas})


def _kernel_inputs(torch, b, t, lengths, gen):
    from madeleine_torch.models.abmil import encoder_weights, pre_attn_mlp
    from madeleine_torch.models.madeleine import MADELEINE
    from madeleine_torch.config import MadeleineConfig
    from madeleine_torch.ops.attn_pool import mask_bias

    cfg = MadeleineConfig.from_dict(flagship_config("bfloat16"))
    model = MADELEINE(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in flagship_state_dict().items()})
    model = model.cuda().eval()
    with torch.no_grad():
        w = encoder_weights(model.wsi_embedders)
        x = torch.from_numpy(gen.standard_normal((b, t, 512)).astype(np.float32)).cuda()
        mask = torch.arange(t)[None, :] < torch.as_tensor(lengths)[:, None]
        bias = mask_bias(mask, b, t, cfg.n_heads, torch.device("cuda"))
        y = pre_attn_mlp(w, x)  # f32 MLP, head-major: K2's input
    return model, mask.cuda(), w, x, bias, y


def _check_k1(torch, w, x, bias, y, n_valid, atol=3e-2):
    """K1 against its plain version twice: with the flagship weights, whose
    attention logits spread by well under one unit (a nearly uniform pool),
    and with wc scaled by PEAK_WC_SCALE, whose logits spread by several units.
    The control: with wc = 0 (a uniform pool) the plain output must differ
    from the peaked one by more than atol, or the check could not see a K1
    whose gates or logits were wrong. y is the f32 MLP output; the logit
    spread is read over the first bag's n_valid tokens."""
    from madeleine_torch.models.abmil import gated_attention_logits
    from madeleine_torch.ops.encode_fused import (encode_fused_cuda,
                                                  encode_pool_fused_plain, kernel_weights)

    wk = kernel_weights(w, torch.bfloat16)
    xb = x.to(torch.bfloat16).contiguous()
    nh, _, e = w["wa"].shape
    report = {}
    for name, scale in (("flagship", 1.0), ("peaked", PEAK_WC_SCALE)):
        wks = dict(wk, wc=wk["wc"] * scale)
        got = encode_fused_cuda(xb, bias, wks)
        want = encode_pool_fused_plain(xb, bias, wks)
        uniform = encode_pool_fused_plain(xb, bias, dict(wks, wc=torch.zeros_like(wks["wc"])))
        logits = gated_attention_logits(dict(w, wc=w["wc"] * scale),
                                        y[0, :n_valid].reshape(n_valid, nh, e))
        torch.cuda.synchronize()
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"encode_fused ({name}): non-finite output")
        err = (got.float() - want.float()).abs().max().item()
        if not err <= atol:
            raise AssertionError(f"encode_fused ({name}): max |kernel - plain| {err} > {atol}")
        report[name] = {
            "wc_scale": scale, "max_abs_err": err,
            "uniform_pool_vs_plain": (uniform.float() - want.float()).abs().max().item(),
            "logit_std_min_head": logits.std(dim=0).min().item(),
            "logit_range_min_head": (logits.max(0).values - logits.min(0).values).min().item()}
    if not report["peaked"]["uniform_pool_vs_plain"] > atol:
        raise AssertionError(f"encode_fused: control failed, a uniform pool is within "
                             f"{atol} of the peaked plain output: {report['peaked']}")
    return report, xb, wk


def _check_k2(torch, w, y, bias, rtol=1e-4, atol=1e-5):
    from madeleine_torch.ops.gated_pool import gated_attention_pool_plain, gated_pool_cuda

    gw = {k: w[k].float().contiguous() for k in ("wa", "ba", "wb", "bb", "wc", "bc")}
    got = gated_pool_cuda(y, bias, **gw)
    want = gated_attention_pool_plain(y, bias, **gw)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError("gated_pool: non-finite output")
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    return (got - want).abs().max().item(), gw


def phase_kernels(state):
    import torch
    from madeleine_torch.models.abmil import abmil_embed, encoder_weights
    from madeleine_torch.ops.encode_fused import (encode_fused_cuda, encode_pool_fused_plain,
                                                  kernel_weights)
    from madeleine_torch.ops.gated_pool import gated_attention_pool_plain, gated_pool_cuda

    gen = np.random.default_rng(SEED)
    b, t = 8, 4096
    lengths = [4096, 4000, 3001, 2048, 1500, 777, 65, 0]   # one empty bag: pools to 0
    model, mask, w, x, bias, y = _kernel_inputs(torch, b, t, lengths, gen)
    k1_report, xb, wk = _check_k1(torch, w, x, bias, y, lengths[0])
    err2, gw = _check_k2(torch, w, y, bias)
    # partial last tile: t = 4057 (63 tiles of 64 + 25 rows)
    t2, lengths2 = 4057, [4057, 4033]
    _, _, w_, x_, bias_, y_ = _kernel_inputs(torch, 2, t2, lengths2, gen)
    k1p_report, _, _ = _check_k1(torch, w_, x_, bias_, y_, lengths2[0])
    err2p, _ = _check_k2(torch, w_, y_, bias_)
    del w_, x_, bias_, y_
    err1 = max(r["max_abs_err"] for r in k1_report.values())
    err1p = max(r["max_abs_err"] for r in k1p_report.values())

    tokens = int(sum(lengths))
    nh, f, e = w["wa"].shape
    E, d_in = nh * e, x.shape[-1]
    k1_flops = tokens * 2.0 * (d_in * e + e * e + e * E + 2 * E * f + E)
    k1_bytes = (tokens * (d_in * 2 + nh * 4) + b * E * 2
                + sum(v.numel() * v.element_size() for v in wk.values()))
    k2_flops = tokens * 2.0 * (2 * E * f + E)
    k2_bytes = (tokens * (E * 4 + nh * 4) + b * E * 4
                + sum(v.numel() * v.element_size() for v in gw.values()))
    k1_ms = cuda_ms(lambda: encode_fused_cuda(xb, bias, wk))
    k1_plain = cuda_ms(lambda: encode_pool_fused_plain(xb, bias, wk), iters=10)
    k2_ms = cuda_ms(lambda: gated_pool_cuda(y, bias, **gw))
    k2_plain = cuda_ms(lambda: gated_attention_pool_plain(y, bias, **gw), iters=10)
    k1_bound = max(k1_flops / PEAK_BF16, k1_bytes / PEAK_BYTES) * 1e3
    k2_bound = max(k2_flops / PEAK_FP32, k2_bytes / PEAK_BYTES) * 1e3
    # the same inputs with every token valid: the kernels' per-token rate
    dense = torch.zeros_like(bias)
    k1_dense = cuda_ms(lambda: encode_fused_cuda(xb, dense, wk))
    k2_dense = cuda_ms(lambda: gated_pool_cuda(y, dense, **gw))
    k1_dense_bound = k1_bound * b * t / tokens
    k2_dense_bound = k2_bound * b * t / tokens
    # what the model layer adds around K1: operands built per call, mask bias
    emb = model.wsi_embedders
    operands_ms = cuda_ms(lambda: kernel_weights(encoder_weights(emb), torch.bfloat16))
    embed_ms = cuda_ms(lambda: abmil_embed(emb, xb, mask=mask))
    state.setdefault("kernels", {}).update({
        "encode_fused": {
            "name": "encode_fused", "route": "cuda",
            "source": "madeleine_torch/csrc/encode_fused.cu",
            "replaces": "madeleine_tpu/ops/encode_fused.py:126",
            "max_abs_err": max(err1, err1p), "ms": k1_ms, "plain_ms": k1_plain,
            "bound_ms": k1_bound,
            "bound_by": "operations" if k1_flops / PEAK_BF16 >= k1_bytes / PEAK_BYTES else "bytes",
            "library_ms": None},
        "gated_pool": {
            "name": "gated_pool", "route": "cuda",
            "source": "madeleine_torch/csrc/gated_pool.cu",
            "replaces": "madeleine_tpu/ops/gated_pool.py:40",
            "max_abs_err": max(err2, err2p), "ms": k2_ms, "plain_ms": k2_plain,
            "bound_ms": k2_bound,
            "bound_by": "operations" if k2_flops / PEAK_FP32 >= k2_bytes / PEAK_BYTES else "bytes",
            "library_ms": None},
    })
    emit({"phase": "kernels", "names": ["encode_fused", "gated_pool"], "b": b, "t": t,
          "lengths": lengths, "valid_tokens": tokens, "partial_tile_t": t2,
          "encode_fused": {"max_abs_err": err1, "max_abs_err_partial": err1p, "atol": 3e-2,
                           "checks": k1_report, "checks_partial": k1p_report,
                           "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound,
                           "share_of_bound": k1_bound / k1_ms, "gflop": k1_flops / 1e9,
                           "ms_all_valid": k1_dense, "bound_ms_all_valid": k1_dense_bound,
                           "operands_ms": operands_ms, "abmil_embed_ms": embed_ms},
          "gated_pool": {"max_abs_err": err2, "max_abs_err_partial": err2p, "rtol": 1e-4,
                         "atol": 1e-5, "ms": k2_ms, "plain_ms": k2_plain,
                         "bound_ms": k2_bound, "share_of_bound": k2_bound / k2_ms,
                         "gflop": k2_flops / 1e9, "ms_all_valid": k2_dense,
                         "bound_ms_all_valid": k2_dense_bound}})


# K3: the eval forward's call (one modality of the canonical batch), bars against its plain version
POOL_SHAPE = (65, 2048, 4, 512)      # b, t, heads, head width
POOL_TAIL_T = 2000                   # 31 tiles of 64 + 16 rows
# (rtol, atol, atol as a share of the bag's max|plain output|): bf16 is one output rounding
POOL_TOL = {"bf16": (2e-2, 0.0, 1e-2), "f32": (1e-4, 1e-5, 0.0)}
POOL_LOGIT_STD = 0.3   # the flagship weights' attention logits spread by well under one unit


def _pool_lengths(b, t):
    """32 full bags, 32 ragged ones from 1 to t - 1 tokens, one empty."""
    return [t] * 32 + [int(n) for n in np.linspace(1, t - 1, b - 33)] + [0]


def _k3_plain(y, l):
    """K3's plain version on its operands: y [b, t, nh*e], pre-masked f32
    logits [b, t, nh] -> [b, nh*e] in y's dtype."""
    from madeleine_torch.ops import attn_pool as ap

    return ap.softmax_pool_plain(l, y.view(*y.shape[:2], l.shape[-1], -1)).to(y.dtype)


def _check_k3(torch, y, logits, mask, tol):
    """K3 against its plain version with the logits as given and peaked
    (x PEAK_WC_SCALE), each within |got - want| <= atol + rtol |want| with
    atol scaled to each bag's largest output; two launches bitwise equal;
    the empty bag 0. The control of each case: a uniform pool (logits 0)
    must break that bar in every full bag (`uniform_miss_full_bags`, the
    least over the full bags of the largest |uniform - want| over the
    allowed error, must exceed 1), or the case could not fail a wrong
    weight where the pool is nearest uniform."""
    from madeleine_torch.ops import attn_pool as ap

    rtol, atol0, atol_share = tol
    l0 = torch.zeros_like(logits).masked_fill(~mask[..., None], ap.NEG_INF)
    uniform = _k3_plain(y, l0).float()
    rep = {}
    for name, scale in (("spread", 1.0), ("peaked", PEAK_WC_SCALE)):
        l = (logits * scale).masked_fill(~mask[..., None], ap.NEG_INF).contiguous()
        got, again = ap.attn_pool_cuda(y, l), ap.attn_pool_cuda(y, l)
        want = _k3_plain(y, l).float()
        torch.cuda.synchronize()
        atol = atol0 + atol_share * want.abs().amax(1, keepdim=True)
        allowed = (atol + rtol * want.abs()).clamp_min(1e-12)   # the empty bag's is 0
        over = (got.float() - want).abs() / allowed
        empty, full = ~mask.any(1), mask.all(1)
        rep[name] = {"max_abs_err": (got.float() - want).abs().max().item(),
                     "atol_range": [atol.min().item(), atol.max().item()],
                     "max_err_over_allowed": over.max().item(),
                     "uniform_miss_full_bags":
                         ((uniform - want).abs() / allowed)[full].amax(1).min().item(),
                     "bitwise_equal": torch.equal(got, again),
                     "finite": bool(torch.isfinite(got.float()).all()),
                     "empty_bags_zero": bool((got[empty] == 0).all())}
        if not (rep[name]["bitwise_equal"] and rep[name]["finite"]
                and rep[name]["empty_bags_zero"]):
            raise AssertionError(f"attn_pool {list(y.shape)} {y.dtype} ({name}): {rep[name]}")
        if not rep[name]["max_err_over_allowed"] <= 1.0:
            raise AssertionError(f"attn_pool {list(y.shape)} {y.dtype} ({name}): outside "
                                 f"atol + rtol |want|: {rep[name]}")
        if not rep[name]["uniform_miss_full_bags"] > 1.0:
            raise AssertionError(f"attn_pool ({name}): control failed, a uniform pool is within "
                                 f"the bar of the plain output: {rep[name]}")
    return rep


def _sdpa_pool(torch, y, l):
    """The library's call for K3's function, timed and checked only:
    scaled_dot_product_attention with zero q and k (so q.k = 0) and the
    logits as an additive mask gives softmax(l) . y per head. The mask is
    laid out head-major [b, nh, 1, t] in y's dtype before the call."""
    import torch.nn.functional as F

    b, t, nh = l.shape
    e = y.shape[-1] // nh
    v = y.view(b, t, nh, e).transpose(1, 2)
    q = torch.zeros(b, nh, 1, e, dtype=y.dtype, device=y.device)
    k = torch.zeros(b, nh, t, e, dtype=y.dtype, device=y.device)
    mask = l.permute(0, 2, 1).contiguous().to(y.dtype)[:, :, None, :]
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask).reshape(b, nh * e)


def phase_pool_kernels(state):
    import torch
    from madeleine_torch.ops import attn_pool as ap

    b, t, nh, e = POOL_SHAPE
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    checks, times = {}, {}
    for label, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        for tt in (t, POOL_TAIL_T):
            y = torch.randn(b, tt, nh * e, generator=g, device="cuda").to(dtype)
            logits = POOL_LOGIT_STD * torch.randn(b, tt, nh, generator=g, device="cuda")
            mask = (torch.arange(tt, device="cuda")[None, :]
                    < torch.tensor(_pool_lengths(b, tt), device="cuda")[:, None])
            checks[f"{label}_t{tt}"] = _check_k3(torch, y, logits, mask, POOL_TOL[label])
        # the eval forward's call: every token valid, t = 2048 (y is the tail's; remake)
        y = torch.randn(b, t, nh * e, generator=g, device="cuda").to(dtype)
        l = POOL_LOGIT_STD * torch.randn(b, t, nh, generator=g, device="cuda")
        ms = cuda_ms(lambda: ap.attn_pool_cuda(y, l), warmup=3, iters=20)
        plain_ms = cuda_ms(lambda: _k3_plain(y, l), warmup=1, iters=5)
        sdpa = _sdpa_pool(torch, y, l)
        library_ms = cuda_ms(sdpa, warmup=3, iters=20)
        library_err = (sdpa().float() - _k3_plain(y, l).float()).abs().max().item()
        nbytes = y.numel() * y.element_size() + l.numel() * 4 + b * nh * e * y.element_size()
        flops = 2.0 * b * t * nh * e + 3.0 * b * t * nh     # a multiply-add per element; exp
        bound, by = _bound(flops, nbytes, PEAK_FP32)
        times[label] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                        "library_max_abs_err": library_err, "bound_ms": bound, "bound_by": by,
                        "share_of_bound": bound / ms, "gb": nbytes / 1e9,
                        "achieved_tb_per_s": nbytes / ms / 1e9}
        del y, l, sdpa
    err = max(r["max_abs_err"] for c in checks.values() for k, r in c.items()
              if isinstance(r, dict))
    st = times["bf16"]
    state.setdefault("kernels", {})["attn_pool"] = {
        "name": "attn_pool", "route": "cuda", "source": "madeleine_torch/csrc/attn_pool.cu",
        "replaces": "madeleine_tpu/ops/attn_pool.py:107", "max_abs_err": err, "ms": st["ms"],
        "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
        "library_ms": st["library_ms"]}
    emit({"phase": "pool_kernels", "shape": POOL_SHAPE, "tail_t": POOL_TAIL_T,
          "lengths": "32 full, 32 from 1 to t-1, 1 empty", "logit_std": POOL_LOGIT_STD,
          "peak_scale": PEAK_WC_SCALE, "tol": POOL_TOL, "checks": checks, "times": times})


def _encoder_train_work(b, t, w, need_dx=False):
    """(flops, bytes) of one K6 and one K7 call: every row of [b, t] is
    computed (masked tokens still get token outputs and residuals); with
    need_dx K7 also computes and writes dx [b, t, d_in] bf16."""
    nh, f, _ = w["wa"].shape
    hd, d_in = w["w1"].shape
    dout, E = w["wt"].shape
    n = b * t
    macs = d_in * hd + hd * hd + hd * E + 2 * E * f + E * dout
    fwd_flops = n * 2.0 * macs
    # dW for all, dX for all but layer 1 (and layer 1 too with need_dx)
    bwd_flops = n * 2.0 * (2 * macs - (0 if need_dx else d_in * hd))
    saved = 2 * (2 * hd + E + 2 * nh * f) + 12          # u1 u2 u3 a_pre b_pre bf16, rstd f32
    wbytes = sum(v.numel() * v.element_size() for v in w.values())
    fwd_bytes = n * (d_in * 2 + dout * 2 + nh * 4 + saved) + wbytes + b * E * 4
    bwd_bytes = n * (d_in * 2 + nh * 4 + dout * 2 + saved) + wbytes + b * E * 4 + 4 * sum(
        v.numel() for v in w.values()) + (n * d_in * 2 if need_dx else 0)
    return fwd_flops, fwd_bytes, bwd_flops, bwd_bytes


def _bound(flops, nbytes, peak_flops=PEAK_BF16):
    """(least ms, "operations" or "bytes") of work at the card's peaks."""
    ops, mem = flops / peak_flops, nbytes / PEAK_BYTES
    return max(ops, mem) * 1e3, ("operations" if ops >= mem else "bytes")


GRAD_RTOL = 1e-2   # relative Frobenius bar of each K7 gradient (bf16 operands, f32 sums)
BC_ATOL = 1e-4     # bc's exact gradient is 0 (softmax shift invariance): absolute bar
POOLED_ATOL = 2e-3  # K6's f32 pooled output (largest error seen: 8.3e-4, peaked weights)
OUT_ATOL = 3e-2    # K6's bf16 tokens and f32 valid logits, as K1
TILE = 64          # K6's pool tile (csrc/encoder_train_fwd.cu POOL_TM)


def _check_train_kernels(torch, w, x, bias, rates, gen, need_dx=False):
    """K6 against its plain version, then K7 against its plain version on the
    same residuals, with a random pooled cotangent and a random dtok (and
    with need_dx its input gradient dx, as the other gradients). K6 and K7
    each run twice and must give bitwise-equal results. Returns (report,
    K6's outputs, K6's arguments, K7's arguments; with need_dx also K7's
    gradients)."""
    from madeleine_torch.ops import encoder_train as et

    b, t, _ = x.shape
    nh, _, e = w["wa"].shape
    fwd_args = (x, bias, w, 1234, 0, *rates)
    got = et.encoder_train_fwd_cuda(*fwd_args)
    again = et.encoder_train_fwd_cuda(*fwd_args)
    with torch.no_grad():
        want = et.encoder_train_fwd_plain(*fwd_args)
    torch.cuda.synchronize()
    rep = {}
    valid = bias == 0
    for name, i in (("pooled", 0), ("tok", 3)):
        if not torch.isfinite(got[i].float()).all():
            raise AssertionError(f"encoder_train_fwd: non-finite {name}")
        rep[f"{name}_err"] = (got[i].float() - want[i].float()).abs().max().item()
    rep["logits_err"] = (got[4] - want[4]).abs()[valid].max().item()
    for k, bar in (("pooled_err", POOLED_ATOL), ("tok_err", OUT_ATOL), ("logits_err", OUT_ATOL)):
        if not rep[k] <= bar:
            raise AssertionError(f"encoder_train_fwd {list(x.shape)} {rates}: {k} {rep[k]} "
                                 f"> {bar}")
    if not all(torch.equal(a, c) for a, c in zip(got[:5], again[:5])):
        raise AssertionError("encoder_train_fwd: two launches differ")
    del again, want
    pooled32, m, s, _, l, saved = got
    g = torch.from_numpy(gen.standard_normal((b, nh * e)).astype(np.float32)).cuda()
    dtok = torch.from_numpy(gen.standard_normal((b, t, w["wt"].shape[0])).astype(np.float32)
                            ).cuda().to(torch.bfloat16)
    inner = (g * pooled32).reshape(b, nh, e).sum(-1)
    bwd_args = (x, l, m, s, g, inner, dtok, saved, w, 1234, 0, *rates)
    gk = et.encoder_train_bwd_cuda(*bwd_args, need_dx=need_dx)
    gk2 = et.encoder_train_bwd_cuda(*bwd_args, need_dx=need_dx)
    with torch.no_grad():
        gp = et.encoder_train_bwd_plain(*bwd_args, need_dx=need_dx)
    torch.cuda.synchronize()
    keys = et.W_KEYS + (("x",) if need_dx else ())
    if set(gk) != set(keys) or not all(torch.equal(gk[k], gk2[k]) for k in keys):
        raise AssertionError("encoder_train_bwd: two launches gave different gradients "
                             f"or outputs {sorted(gk)}")
    del gk2
    errs, abs_errs = {}, {}
    for k in keys:
        if not torch.isfinite(gk[k]).all():
            raise AssertionError(f"encoder_train_bwd: non-finite d{k}")
        diff = (gk[k] - gp[k]).float()
        abs_errs[k] = diff.abs().max().item()
        if k == "bc":
            errs[k] = diff.abs().max().item()
            ok = errs[k] <= BC_ATOL
        else:
            errs[k] = (diff.norm() / gp[k].float().norm().clamp_min(1e-30)).item()
            ok = errs[k] <= GRAD_RTOL
        if not ok:
            raise AssertionError(f"encoder_train_bwd {list(x.shape)} {rates}: d{k} error "
                                 f"{errs[k]}")
    rep["grad_rel_fro"] = errs
    rep["grad_max_rel_fro"] = max(v for k, v in errs.items() if k != "bc")
    rep["grad_max_abs_err"] = max(abs_errs.values())
    rep["deterministic"] = True
    if need_dx:
        return rep, got, fwd_args, bwd_args, gk
    return rep, got, fwd_args, bwd_args


def phase_train_kernels(state):
    import torch
    from madeleine_torch.models.madeleine import MADELEINE, train_weights
    from madeleine_torch.config import MadeleineConfig
    from madeleine_torch.ops import encoder_train as et

    gen = np.random.default_rng(SEED + 3)
    cfg = MadeleineConfig.from_dict(flagship_config("bfloat16"))
    model = MADELEINE(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in flagship_state_dict().items()})
    model = model.cuda()
    with torch.no_grad():
        w = {k: v.detach().contiguous() for k, v in train_weights(model, torch.bfloat16).items()}
    weights = {"flagship": w, "peaked": dict(w, wc=(w["wc"] * PEAK_WC_SCALE).contiguous())}
    real = (et.PRE_RATE, et.GATE_RATE)

    def inputs(mask):
        b, t = mask.shape
        x = torch.from_numpy(gen.standard_normal((b, t, 512)).astype(np.float32)).cuda()
        return x.to(torch.bfloat16).contiguous(), et.token_mask_bias(mask.cuda(), b, t, "cuda")

    def prefix_mask(t, lengths):
        return torch.arange(t)[None, :] < torch.as_tensor(lengths)[:, None]

    b, t = 8, 4096
    lengths = [4096, 4000, 3001, 2048, 1500, 777, 65, 0]
    x, bias = inputs(prefix_mask(t, lengths))
    checks, timed = {}, {}
    for wname, ws in weights.items():
        for rates in ((0.0, 0.0), real):
            rep, fwd, fa, ba = _check_train_kernels(torch, ws, x, bias, rates, gen)
            checks[f"{wname}_{rates[0]}_{rates[1]}"] = rep
            if wname == "flagship" and rates == real:
                timed["smoke"] = (fa, ba)
        # control: a uniform pool (wc = 0) must miss the pooled bar
        with torch.no_grad():
            uni = et.encoder_train_fwd_plain(x, bias, dict(ws, wc=torch.zeros_like(ws["wc"])),
                                             1234, 0, *rates)[0]
        checks[f"{wname}_uniform_pool_vs_plain"] = (uni - fwd[0]).abs().max().item()
        if not checks[f"{wname}_uniform_pool_vs_plain"] > POOLED_ATOL:
            raise AssertionError(f"train_kernels ({wname}): control failed, a uniform pool is "
                                 f"within {POOLED_ATOL} of the kernel's output")
    # partial last tile: t = 4057 = 63 tiles of 64 + 25 rows. Bag 0 is valid on
    # its last 57 tokens only (the end of tile 62 and all of tile 63), bag 1 on
    # every token, so a pool that dropped the partial tile, or read past t into
    # bag 1, would move bag 0's pooled output by far more than the bar
    t2, tail_from = 4057, 4000
    mask2 = torch.ones(2, t2, dtype=torch.bool)
    mask2[0, :tail_from] = False
    x2, bias2 = inputs(mask2)
    mask_cut = mask2.clone()
    mask_cut[:, (t2 // TILE) * TILE:] = False
    bias_cut = et.token_mask_bias(mask_cut.cuda(), 2, t2, "cuda")
    for wname, ws in weights.items():
        for rates in ((0.0, 0.0), real):
            checks[f"partial_t_{wname}_{rates[0]}_{rates[1]}"], fwd, _, _ = \
                _check_train_kernels(torch, ws, x2, bias2, rates, gen)
        # control: the plain pool without the partial tile must miss the pooled bar
        with torch.no_grad():
            cut = et.encoder_train_fwd_plain(x2, bias_cut, ws, 1234, 0, *rates)[0]
        checks[f"partial_t_{wname}_tail_dropped_vs_plain"] = (cut - fwd[0]).abs().max().item()
        if not checks[f"partial_t_{wname}_tail_dropped_vs_plain"] > POOLED_ATOL:
            raise AssertionError(f"train_kernels ({wname}): control failed, dropping the "
                                 f"partial tile stays within {POOLED_ATOL}")
    del x2, bias2, bias_cut, fwd

    # the train step's call shape [65, 2048], every token valid, real rates:
    # checked as above, then timed with the smoke shape
    xs, bs_ = inputs(torch.ones(65, 2048, dtype=torch.bool))
    checks[f"step_call_{real[0]}_{real[1]}"], _, fa, ba = _check_train_kernels(
        torch, w, xs, bs_, real, gen)
    timed["step_call"] = (fa, ba)
    del xs, bs_, fa, ba

    # the stain-encoded step's call: d_in 544 (the last 32 columns the stain
    # code), K7 with dx. The table's gradient is dx's stain columns summed
    # over the call's rows; autograd sums them in bf16, held here to the f32 sum
    model_se = flagship_model(torch, "bfloat16", stain_encoding=True)
    with torch.no_grad():
        w_se = {k: v.detach().contiguous()
                for k, v in train_weights(model_se, torch.bfloat16).items()}
        code = model_se.embedding.weight[1].to(torch.bfloat16)
    xs, bs_ = inputs(torch.ones(65, 2048, dtype=torch.bool))
    xs = torch.cat([xs, code.expand(65, 2048, -1)], dim=-1).contiguous()
    checks[f"step_call_se_{real[0]}_{real[1]}"], _, fa, ba, gk = _check_train_kernels(
        torch, w_se, xs, bs_, real, gen, need_dx=True)
    d = cfg.patch_embedding_dim
    with torch.no_grad():
        tab_bf16 = gk["x"][..., d:].sum((0, 1)).float()
        tab_f32 = gk["x"][..., d:].float().sum((0, 1))
    checks["table_grad_bf16_sum_vs_f32_rel"] = _rel_fro(tab_bf16, tab_f32)
    if not checks["table_grad_bf16_sum_vs_f32_rel"] <= GRAD_RTOL:
        raise AssertionError(f"train_kernels: the bf16 sum of dx's stain columns misses the "
                             f"f32 sum: {checks['table_grad_bf16_sum_vs_f32_rel']}")
    timed["step_call_se"] = (fa, ba)
    del xs, bs_, fa, ba, gk

    times = {}
    for shape_name, (fa, ba) in timed.items():
        bb, tt, d_in = fa[0].shape
        dx = shape_name == "step_call_se"
        k6 = cuda_ms(lambda: et.encoder_train_fwd_cuda(*fa))
        k7 = cuda_ms(lambda: et.encoder_train_bwd_cuda(*ba, need_dx=dx))
        with torch.no_grad():
            k6p = cuda_ms(lambda: et.encoder_train_fwd_plain(*fa), warmup=1, iters=5)
            k7p = cuda_ms(lambda: et.encoder_train_bwd_plain(*ba, need_dx=dx), warmup=1, iters=5)
        ff, fb, bf, bb_ = _encoder_train_work(bb, tt, fa[2], need_dx=dx)
        (k6b, k6by), (k7b, k7by) = _bound(ff, fb), _bound(bf, bb_)
        times[shape_name] = {"b": bb, "t": tt, "d_in": d_in, "need_dx": dx,
                             "fwd_ms": k6, "fwd_plain_ms": k6p,
                             "fwd_bound_ms": k6b, "fwd_bound_by": k6by,
                             "fwd_share_of_bound": k6b / k6, "bwd_ms": k7,
                             "bwd_plain_ms": k7p, "bwd_bound_ms": k7b, "bwd_bound_by": k7by,
                             "bwd_share_of_bound": k7b / k7, "fwd_gflop": ff / 1e9,
                             "bwd_gflop": bf / 1e9, "fwd_gb": fb / 1e9, "bwd_gb": bb_ / 1e9}
    del timed, fa, ba
    st = times["step_call"]
    reps = [r for r in checks.values() if isinstance(r, dict)]
    err_f = max(max(r["pooled_err"], r["tok_err"], r["logits_err"]) for r in reps)
    err_b = max(r["grad_max_abs_err"] for r in reps)
    state.setdefault("kernels", {}).update({
        "encoder_train_fwd": {
            "name": "encoder_train_fwd", "route": "cuda",
            "source": "madeleine_torch/csrc/encoder_train_fwd.cu",
            "replaces": "madeleine_tpu/ops/encoder_train.py:168",
            "max_abs_err": err_f, "ms": st["fwd_ms"], "plain_ms": st["fwd_plain_ms"],
            "bound_ms": st["fwd_bound_ms"], "bound_by": st["fwd_bound_by"],
            "library_ms": None},
        "encoder_train_bwd": {
            "name": "encoder_train_bwd", "route": "cuda",
            "source": "madeleine_torch/csrc/encoder_train_bwd.cu",
            "replaces": "madeleine_tpu/ops/encoder_train.py:262",
            "max_abs_err": err_b, "ms": st["bwd_ms"], "plain_ms": st["bwd_plain_ms"],
            "bound_ms": st["bwd_bound_ms"], "bound_by": st["bwd_bound_by"],
            "library_ms": None},
    })
    emit({"phase": "train_kernels", "b": b, "t": t, "lengths": lengths, "partial_tile_t": t2,
          "partial_tile_bag0_valid_from": tail_from, "pooled_atol": POOLED_ATOL,
          "atol_tok_logits": OUT_ATOL, "grad_rtol_fro": GRAD_RTOL, "bc_atol": BC_ATOL,
          "checks": checks, "times": times})


# GOT kernels: relative Frobenius bars against the plain versions on the card
GOT_PLAN_RTOL = 1e-4   # T (K8) and gamma (K10)
GOT_GRAD_RTOL = 1e-3   # dC (K9)
GOT_STEP_SHAPE = (260, 256, 256)   # 4 stain pairs x 65 cases, 256 tokens subsampled
GOT_ODD_SHAPE = (7, 256, 192)
# operations per element per IPOT iteration: Q = A T, Q sigma, the row add, Q delta,
# the column add, (delta Q) sigma' (two products); the adjoint as csrc/ipot_bwd.cu's
# header writes it needs 18 more (each product and add once); exp(-C/beta) 2
IPOT_OPS, IPOT_ADJ_OPS, EXP_OPS = 7, 18, 2


def _rel_fro(a, b) -> float:
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def _got_costs(torch, b, n, m, gen, d=128):
    """C, Cs, Ct, Cst built as the GOT path builds them, from random tokens."""
    from madeleine_torch.ops import losses as L
    from madeleine_torch.ops.got_glue import cst_plain

    v = torch.from_numpy(gen.standard_normal((b, n, d)).astype(np.float32)).cuda()
    q = torch.from_numpy(gen.standard_normal((b, m, d)).astype(np.float32)).cuda()
    with torch.no_grad():
        C = L._threshold_relu(L.cosine_cost(v, q), None)
        Cs = L._threshold_relu(L.cosine_cost(v, v), None)
        Ct = L._threshold_relu(L.cosine_cost(q, q), None)
        return C, Cs, Ct, cst_plain(Cs, Ct)


def _got_work(b, n, m, iters=30, gw_outer=5, gw_iters=20):
    """(flops, bytes) of K8, K9 and K10 at their step settings: each input
    read once, each output written once."""
    nm = n * m
    k8 = (b * nm * (iters * IPOT_OPS + EXP_OPS), 2 * b * nm * 4)
    k9 = (b * nm * (iters * (IPOT_OPS + IPOT_ADJ_OPS) + 2 * EXP_OPS), 3 * b * nm * 4)
    gemm = 2 * (n * n * m + n * m * m)              # two products per outer step
    k10 = (b * gw_outer * (gemm + nm * (gw_iters * IPOT_OPS + EXP_OPS + 2)),
           b * (n * n + m * m + 2 * nm) * 4)
    return {"ipot_fwd": k8, "ipot_bwd": k9, "gw_gamma": k10}


def _check_got(torch, C, Cs, Ct, Cst):
    """Each of K8/K9/K10 against its plain version, its control and a second
    launch; returns the report (bars enforced by the caller)."""
    from madeleine_torch.ops import ipot as I

    rep = {}
    for beta, iters in ((0.5, 30), (0.1, 20)):
        T = I.ipot_plan_cuda(C, beta, iters)
        T2 = I.ipot_plan_cuda(C, beta, iters)
        want = I.ipot_plan_plain(C, beta, iters)
        short = I.ipot_plan_plain(C, beta, iters - 1)
        torch.cuda.synchronize()
        rep[f"ipot_fwd_{beta}_{iters}"] = {
            "rel_fro": _rel_fro(T, want), "max_abs_err": (T - want).abs().max().item(),
            "control": _rel_fro(short, want), "control_is": f"{iters - 1} iterations",
            "bitwise_equal": torch.equal(T, T2), "finite": bool(torch.isfinite(T).all())}
        del T, T2, want, short
    dC = I.ipot_plan_bwd_cuda(C, C, 0.5, 30)
    dC2 = I.ipot_plan_bwd_cuda(C, C, 0.5, 30)
    want = I.ipot_plan_bwd_plain(C, C, 0.5, 30)
    short = I.ipot_plan_bwd_plain(C, C, 0.5, 29)
    torch.cuda.synchronize()
    rep["ipot_bwd_0.5_30"] = {
        "rel_fro": _rel_fro(dC, want), "max_abs_err": (dC - want).abs().max().item(),
        "control": _rel_fro(short, want), "control_is": "29 iterations",
        "bitwise_equal": torch.equal(dC, dC2), "finite": bool(torch.isfinite(dC).all())}
    del dC, dC2, want, short
    g = I.gw_gamma_cuda(Cs, Ct, Cst, 0.1, 5, 20)
    g2 = I.gw_gamma_cuda(Cs, Ct, Cst, 0.1, 5, 20)
    want = I.gw_gamma_plain(Cs, Ct, Cst, 0.1, 5, 20)
    # the GW loop nears its fixed point within 5 outer steps, so one step
    # short may lie within the bar: the control is the largest outer count
    # below 5 whose plan lies beyond it (every count tried is reported)
    tried = {}
    for outer in (4, 3, 2, 1):
        tried[outer] = _rel_fro(I.gw_gamma_plain(Cs, Ct, Cst, 0.1, outer, 20), want)
        if tried[outer] > GOT_PLAN_RTOL:
            break
    # the f32 floor: both against the plain version in float64
    ref64 = I.gw_gamma_plain(Cs.double(), Ct.double(), Cst.double(), 0.1, 5, 20)
    torch.cuda.synchronize()
    rep["gw_gamma_0.1_5x20"] = {
        "rel_fro": _rel_fro(g, want), "max_abs_err": (g - want).abs().max().item(),
        "control": tried[outer], "control_is": f"{outer} outer steps",
        "controls_tried": tried,
        "kernel_vs_f64": _rel_fro(g.double(), ref64), "plain_vs_f64": _rel_fro(want.double(), ref64),
        "bitwise_equal": torch.equal(g, g2), "finite": bool(torch.isfinite(g).all())}
    return rep


def _enforce_got(rep, where):
    for name, r in rep.items():
        bar = GOT_GRAD_RTOL if name.startswith("ipot_bwd") else GOT_PLAN_RTOL
        if not (r["finite"] and r["bitwise_equal"] and r["rel_fro"] <= bar):
            raise AssertionError(f"got_kernels {where} {name}: {r} (bar {bar})")
        if not r["control"] > bar:
            raise AssertionError(f"got_kernels {where} {name}: control within the bar: {r}")


def phase_got_kernels(state):
    import torch
    from madeleine_torch.ops import ipot as I

    gen = np.random.default_rng(SEED + 5)
    checks = {}
    for label, shape in (("odd", GOT_ODD_SHAPE), ("step", GOT_STEP_SHAPE)):
        C, Cs, Ct, Cst = _got_costs(torch, *shape, gen)
        checks[label] = _check_got(torch, C, Cs, Ct, Cst)
    # report every number first, then enforce the bars
    emit({"phase": "got_kernels", "checks": checks, "plan_rtol_fro": GOT_PLAN_RTOL,
          "grad_rtol_fro": GOT_GRAD_RTOL, "shapes": {"odd": GOT_ODD_SHAPE,
                                                     "step": GOT_STEP_SHAPE}})
    for label, rep in checks.items():
        _enforce_got(rep, label)

    # times at the step's shape (C, Cs, Ct, Cst are the step shape's now)
    fns = {"ipot_fwd": (lambda: I.ipot_plan_cuda(C, 0.5, 30),
                        lambda: I.ipot_plan_plain(C, 0.5, 30)),
           "ipot_bwd": (lambda: I.ipot_plan_bwd_cuda(C, C, 0.5, 30),
                        lambda: I.ipot_plan_bwd_plain(C, C, 0.5, 30)),
           "gw_gamma": (lambda: I.gw_gamma_cuda(Cs, Ct, Cst, 0.1, 5, 20),
                        lambda: I.gw_gamma_plain(Cs, Ct, Cst, 0.1, 5, 20))}
    work = _got_work(*GOT_STEP_SHAPE)
    sources = {"ipot_fwd": ("csrc/ipot_fwd.cu", "madeleine_tpu/ops/ipot.py:154"),
               "ipot_bwd": ("csrc/ipot_bwd.cu", "madeleine_tpu/ops/ipot.py:182"),
               "gw_gamma": ("csrc/gw_gamma.cu", "madeleine_tpu/ops/ipot.py:254")}
    err_key = {"ipot_fwd": ("ipot_fwd_0.5_30", "ipot_fwd_0.1_20"),
               "ipot_bwd": ("ipot_bwd_0.5_30",), "gw_gamma": ("gw_gamma_0.1_5x20",)}
    times = {}
    for name, (kernel, plain) in fns.items():
        ms = cuda_ms(kernel, warmup=2, iters=10)
        plain_ms = cuda_ms(plain, warmup=1, iters=3)
        flops, nbytes = work[name]
        ops, mem = flops / PEAK_FP32, nbytes / PEAK_BYTES
        bound = max(ops, mem) * 1e3
        times[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                       "bound_by": "operations" if ops >= mem else "bytes",
                       "share_of_bound": bound / ms, "gflop": flops / 1e9, "gb": nbytes / 1e9}
        state.setdefault("kernels", {})[name] = {
            "name": name, "route": "cuda", "source": "madeleine_torch/" + sources[name][0],
            "replaces": sources[name][1],
            "max_abs_err": max(checks[lbl][k]["max_abs_err"] for lbl in checks
                               for k in err_key[name]),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": times[name]["bound_by"], "library_ms": None}
    emit({"phase": "got_kernels", "shape": GOT_STEP_SHAPE, "times": times,
          "k9_history_gb": 30 * GOT_STEP_SHAPE[0] * 256 * 256 * 4 / 1e9})


# GOT glue kernels: relative Frobenius bars against the plain versions on the card
GLUE_TB_RTOL = 1e-6     # K11/K12 outputs: elementwise work plus fixed-order row sums
GLUE_DTHR_RTOL = 1e-5   # K12's dthr: sums over whole problems
GLUE_GWT_RTOL = 1e-5    # K13/K14: full f32 products
GLUE_KERNELS = ("threshold_build_fwd", "threshold_build_bwd", "gw_trace_fwd", "gw_trace_bwd")


def _glue_work(b, n, m):
    """(flops, bytes) of K11-K14: each input read once, each output written
    once; the elementwise operations counted once each, 2 n m k per product."""
    nm, nn, mm = n * m, n * n, m * m
    k11 = (b * (nm + nn + mm + 2 * (nn + mm) + nm), 4 * b * (2 * nm + nn + mm + nm + nn + mm + 3))
    k12 = (b * (nm + 4 * (nn + mm) + 2 * nm),
           4 * b * ((nm + nn + mm + 3) + (nm + nn + mm + nm) + (nm + nn + mm + 3)))
    k13 = (2 * b * (n * n * m + n * m * m) + 3 * b * nm, 4 * b * (nn + mm + 2 * nm + 1))
    k14 = (2 * b * (2 * n * m * m + 2 * n * n * m) + b * (nn + mm + nm),
           4 * b * (nn + mm + nm + 1) + 4 * b * (nn + mm + nm))
    return {"threshold_build_fwd": k11, "threshold_build_bwd": k12, "gw_trace_fwd": k13,
            "gw_trace_bwd": k14}


def _glue_inputs(torch, b, n, m, gen, d=128):
    """C0, Cs0, Ct0 cosine costs of random tokens, per-problem thresholds
    min + 0.1 (max - min) [b, 3], and the GW plan of the thresholded costs
    (K10), as the GOT path builds them."""
    from madeleine_torch.ops import got_glue as G
    from madeleine_torch.ops import ipot as I
    from madeleine_torch.ops import losses as L

    v = torch.from_numpy(gen.standard_normal((b, n, d)).astype(np.float32)).cuda()
    q = torch.from_numpy(gen.standard_normal((b, m, d)).astype(np.float32)).cuda()
    with torch.no_grad():
        X0 = (L.cosine_cost(v, q), L.cosine_cost(v, v), L.cosine_cost(q, q))
        thr = torch.stack([x.amin((1, 2)) + 0.1 * (x.amax((1, 2)) - x.amin((1, 2)))
                           for x in X0], dim=1).contiguous()
        _, Cs, Ct, Cst = G.threshold_build_plain(*X0, thr)
        gamma = I.gw_gamma_cuda(Cs, Ct, Cst, 0.1, 5, 20)
    return X0, thr, gamma


def _check_glue(torch, X0, thr, gamma, gen):
    """K11-K14 each against its plain version (relative Frobenius per
    output), a second launch of each, and a control fed a neighbouring
    problem's threshold (K11/K12) or plan (K13/K14), which must miss."""
    from madeleine_torch.ops import got_glue as G

    b, n, m = X0[0].shape
    rep = {}

    def entry(got, again, want, control, names, control_is):
        errs = {k: _rel_fro(g, w) for k, g, w in zip(names, got, want)}
        return {"rel_fro": errs, "max_abs_err": max((g - w).abs().max().item()
                                                    for g, w in zip(got, want)),
                "control": {k: _rel_fro(c, w) for k, c, w in zip(names, control, want)},
                "control_is": control_is,
                "bitwise_equal": all(torch.equal(g, a) for g, a in zip(got, again)),
                "finite": all(bool(torch.isfinite(g).all()) for g in got)}

    rolled = thr.roll(1, 0).contiguous()
    outs = G.threshold_build_cuda(*X0, thr)
    rep["threshold_build_fwd"] = entry(
        outs, G.threshold_build_cuda(*X0, thr), G.threshold_build_plain(*X0, thr),
        G.threshold_build_plain(*X0, rolled), ("C", "Cs", "Ct", "Cst"), "thresholds rolled")
    cots = [torch.from_numpy(gen.standard_normal(tuple(o.shape)).astype(np.float32)).cuda()
            for o in outs]
    rep["threshold_build_bwd"] = entry(
        G.threshold_build_bwd_cuda(*X0, thr, *cots), G.threshold_build_bwd_cuda(*X0, thr, *cots),
        G.threshold_build_bwd_plain(*X0, thr, *cots),
        G.threshold_build_bwd_plain(*X0, rolled, *cots), ("dC0", "dCs0", "dCt0", "dthr"),
        "thresholds rolled")
    _, Cs, Ct, Cst = outs
    groll = gamma.roll(1, 0).contiguous()
    rep["gw_trace_fwd"] = entry(
        [G.gw_trace_cuda(Cs, Ct, Cst, gamma)], [G.gw_trace_cuda(Cs, Ct, Cst, gamma)],
        [G.gw_trace_plain(Cs, Ct, Cst, gamma)], [G.gw_trace_plain(Cs, Ct, Cst, groll)],
        ("out",), "gamma rolled")
    dout = torch.from_numpy(gen.standard_normal(b).astype(np.float32)).cuda()
    rep["gw_trace_bwd"] = entry(
        G.gw_trace_bwd_cuda(Cs, Ct, gamma, dout), G.gw_trace_bwd_cuda(Cs, Ct, gamma, dout),
        G.gw_trace_bwd_plain(Cs, Ct, Cst, gamma, dout),
        G.gw_trace_bwd_plain(Cs, Ct, Cst, groll, dout), ("dCs", "dCt", "dCst"), "gamma rolled")
    torch.cuda.synchronize()
    return rep


def _glue_bar(kernel, output):
    if kernel.startswith("gw_trace"):
        return GLUE_GWT_RTOL
    return GLUE_DTHR_RTOL if output == "dthr" else GLUE_TB_RTOL


def _enforce_glue(rep, where):
    for kernel, r in rep.items():
        if not (r["finite"] and r["bitwise_equal"]):
            raise AssertionError(f"glue_kernels {where} {kernel}: {r}")
        for out, err in r["rel_fro"].items():
            bar = _glue_bar(kernel, out)
            if not err <= bar:
                raise AssertionError(f"glue_kernels {where} {kernel} {out}: {err} > {bar}")
            if not r["control"][out] > bar:
                raise AssertionError(f"glue_kernels {where} {kernel} {out}: control within "
                                     f"the bar: {r}")


def phase_glue_kernels(state):
    import torch
    from madeleine_torch.ops import got_glue as G

    gen = np.random.default_rng(SEED + 6)
    checks = {}
    for label, shape in (("odd", GOT_ODD_SHAPE), ("step", GOT_STEP_SHAPE)):
        X0, thr, gamma = _glue_inputs(torch, *shape, gen)
        checks[label] = _check_glue(torch, X0, thr, gamma, gen)
    emit({"phase": "glue_kernels", "checks": checks, "tb_rtol_fro": GLUE_TB_RTOL,
          "dthr_rtol_fro": GLUE_DTHR_RTOL, "gw_trace_rtol_fro": GLUE_GWT_RTOL,
          "shapes": {"odd": GOT_ODD_SHAPE, "step": GOT_STEP_SHAPE}})
    for label, rep in checks.items():
        _enforce_glue(rep, label)

    # times at the step's shape (X0, thr and gamma are the step shape's now)
    outs = G.threshold_build_cuda(*X0, thr)
    _, Cs, Ct, Cst = outs
    cots = [torch.randn_like(o) for o in outs]
    dout = torch.randn(X0[0].shape[0], device="cuda")
    fns = {"threshold_build_fwd": (lambda: G.threshold_build_cuda(*X0, thr),
                                   lambda: G.threshold_build_plain(*X0, thr)),
           "threshold_build_bwd": (lambda: G.threshold_build_bwd_cuda(*X0, thr, *cots),
                                   lambda: G.threshold_build_bwd_plain(*X0, thr, *cots)),
           "gw_trace_fwd": (lambda: G.gw_trace_cuda(Cs, Ct, Cst, gamma),
                            lambda: G.gw_trace_plain(Cs, Ct, Cst, gamma)),
           "gw_trace_bwd": (lambda: G.gw_trace_bwd_cuda(Cs, Ct, gamma, dout),
                            lambda: G.gw_trace_bwd_plain(Cs, Ct, Cst, gamma, dout))}
    replaces = {"threshold_build_fwd": "madeleine_tpu/ops/got_glue.py:133",
                "threshold_build_bwd": "madeleine_tpu/ops/got_glue.py:166",
                "gw_trace_fwd": "madeleine_tpu/ops/got_glue.py:265",
                "gw_trace_bwd": "madeleine_tpu/ops/got_glue.py:292"}
    work = _glue_work(*GOT_STEP_SHAPE)
    times = {}
    for name, (kernel, plain) in fns.items():
        ms = cuda_ms(kernel, warmup=2, iters=10)
        plain_ms = cuda_ms(plain, warmup=1, iters=5)
        flops, nbytes = work[name]
        ops, mem = flops / PEAK_FP32, nbytes / PEAK_BYTES
        bound = max(ops, mem) * 1e3
        times[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                       "bound_by": "operations" if ops >= mem else "bytes",
                       "share_of_bound": bound / ms, "gflop": flops / 1e9, "gb": nbytes / 1e9}
        state.setdefault("kernels", {})[name] = {
            "name": name, "route": "cuda", "source": "madeleine_torch/csrc/got_glue.cu",
            "replaces": replaces[name],
            "max_abs_err": max(checks[lbl][name]["max_abs_err"] for lbl in checks),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": times[name]["bound_by"], "library_ms": None}
    emit({"phase": "glue_kernels", "shape": GOT_STEP_SHAPE, "times": times,
          "glue_kernels_ms_per_step": sum(t["ms"] for t in times.values()),
          "glue_plain_ms_per_step": sum(t["plain_ms"] for t in times.values())})


PEROP_STEP_SHAPE = (65, 2048)   # the train step's call shape, one modality
# the checked shapes: the step's, a long bag, and partial last tiles of the GEMM
# (128 rows) and of the row kernels (64 rows): 2 x 4057 = 8114 rows
PEROP_SHAPES = (PEROP_STEP_SHAPE, (8, 4096), (2, 4057))
PEROP_KERNELS = ("preattn_fwd", "preattn_bwd", "gated_logits_fwd", "gated_logits_bwd",
                 "linear_tok_fwd", "linear_tok_bwd")
# kernel -> (source, the TPU kernel it replaces)
PEROP_SOURCES = {
    "preattn_fwd": ("madeleine_torch/csrc/preattn.cu", "madeleine_tpu/ops/preattn.py:134"),
    "preattn_bwd": ("madeleine_torch/csrc/preattn.cu", "madeleine_tpu/ops/preattn.py:200"),
    "gated_logits_fwd": ("madeleine_torch/csrc/gated_logits.cu",
                         "madeleine_tpu/ops/gated_logits.py:78"),
    "gated_logits_bwd": ("madeleine_torch/csrc/gated_logits.cu",
                         "madeleine_tpu/ops/gated_logits.py:96"),
    "linear_tok_fwd": ("madeleine_torch/csrc/linear_tok.cu", "madeleine_tpu/ops/linear_tok.py:28"),
    "linear_tok_bwd": ("madeleine_torch/csrc/linear_tok.cu", "madeleine_tpu/ops/linear_tok.py:35"),
}


def _perop_work(b, t, w, need_dx=False):
    """{kernel: (flops, bytes)} of kernels 15-20 at [b, t]: the products of
    each op (a backward kernel also recomputes its op's forward products,
    the TPU ops' residuals being the inputs and the seed); each input read
    once, each output written once."""
    hd, d_in = w["w1"].shape
    E = w["w3"].shape[0]
    nh, f, e = w["wa"].shape
    dout = w["wt"].shape[0]
    n = b * t
    pre = ("w1", "b1", "s1", "t1", "w2", "b2", "s2", "t2", "w3", "b3", "s3", "t3")
    gate = ("wa", "ba", "wb", "bb", "wc", "bc")

    def wbytes(keys):
        return sum(w[k].numel() * w[k].element_size() for k in keys)

    def gbytes(keys):   # f32 gradients
        return sum(w[k].numel() * 4 for k in keys)

    pre_macs, gate_macs, tok_macs = d_in * hd + hd * hd + hd * E, 2 * nh * e * f, E * dout
    return {
        "preattn_fwd": (2.0 * n * pre_macs, n * (d_in + E) * 2 + wbytes(pre)),
        "preattn_bwd": (2.0 * n * (3 * pre_macs - (0 if need_dx else d_in * hd)),
                        n * (d_in + E + (d_in if need_dx else 0)) * 2 + wbytes(pre)
                        + gbytes(pre)),
        "gated_logits_fwd": (2.0 * n * gate_macs, n * (E * 2 + nh * 4) + wbytes(gate)),
        "gated_logits_bwd": (6.0 * n * gate_macs,
                             n * (2 * E * 2 + nh * 4) + wbytes(gate) + gbytes(gate)),
        "linear_tok_fwd": (2.0 * n * tok_macs, n * (E + dout) * 2 + wbytes(("wt", "bt"))),
        "linear_tok_bwd": (4.0 * n * tok_macs, n * (2 * E + dout) * 2 + wbytes(("wt",))
                           + gbytes(("wt", "bt"))),
    }


def _perop_calls(torch, w, x, rates, gen, seed=1234, row_offset=3, need_dx=False):
    """{kernel: (CUDA wrapper, plain version, args, kwargs)} of kernels 15-20
    on x: gated_logits and linear_tok read preattn's kernel output y; the
    cotangents are random (dy, g in bf16, dl in f32)."""
    from madeleine_torch.ops import gated_logits as gl
    from madeleine_torch.ops import linear_tok as lt
    from madeleine_torch.ops import preattn as pa

    b, t, _ = x.shape
    pre, gate = rates
    y = pa.preattn_fwd_cuda(x, w, seed, row_offset, pre)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.from_numpy(gen.standard_normal(shape).astype(np.float32)).cuda().to(dtype)

    dy = randn(b, t, w["w3"].shape[0])
    dl = randn(b, t, w["wa"].shape[0], dtype=torch.float32)
    g = randn(b, t, w["wt"].shape[0])
    return {
        "preattn_fwd": (pa.preattn_fwd_cuda, pa.preattn_fwd_plain, (x, w, seed, row_offset, pre),
                        {}),
        "preattn_bwd": (pa.preattn_bwd_cuda, pa.preattn_bwd_plain,
                        (x, dy, w, seed, row_offset, pre), {"need_dx": need_dx}),
        "gated_logits_fwd": (gl.gated_logits_fwd_cuda, gl.gated_logits_fwd_plain,
                             (y, w, seed, row_offset, gate), {}),
        "gated_logits_bwd": (gl.gated_logits_bwd_cuda, gl.gated_logits_bwd_plain,
                             (y, dl, w, seed, row_offset, gate), {}),
        "linear_tok_fwd": (lt.linear_tok_fwd_cuda, lt.linear_tok_fwd_plain,
                           (y, w["wt"], w["bt"]), {}),
        "linear_tok_bwd": (lt.linear_tok_bwd_cuda, lt.linear_tok_bwd_plain, (y, g, w["wt"]), {}),
    }


def _bf16_ulp(torch, v):
    """One bf16 rounding step at each value of v (f32): 2^(floor(log2|v|) - 7)."""
    return torch.ldexp(torch.ones_like(v), torch.frexp(v).exponent - 8)


def _check_perop(torch, calls, where):
    """Each kernel of `calls` twice (bitwise equal) against its plain version:
    a forward's output at OUT_ATOL, or for a bf16 output one bf16 rounding
    step of the plain value where that is larger (preattn's y reaches |y| of
    4-8, where a rounding flip from another f32 summation order is 0.031); a
    backward's outputs (dx / dy and the f32 parameter gradients) at
    GRAD_RTOL relative Frobenius. Returns {kernel: {"max_abs_err", and for a
    forward "max_err_over_bar", for a backward "grad_rel_fro"}}."""
    rep = {}
    for name, (kern, plain, args, kw) in calls.items():
        got, again = kern(*args, **kw), kern(*args, **kw)
        with torch.no_grad():
            want = plain(*args, **kw)
        torch.cuda.synchronize()
        if isinstance(got, torch.Tensor):
            got, again, want = {"out": got}, {"out": again}, {"out": want}
        if set(got) != set(want) or not all(torch.equal(got[k], again[k]) for k in got):
            raise AssertionError(f"{name} {where}: two launches differ, or outputs {sorted(got)}")
        errs, abs_err = {}, 0.0
        for k in want:
            a, b = got[k].float(), want[k].float()
            if not torch.isfinite(a).all():
                raise AssertionError(f"{name} {where}: non-finite {k}")
            abs_err = max(abs_err, (a - b).abs().max().item())
            errs[k] = _rel_fro(a, b)
        if name.endswith("_fwd"):
            a, b = got["out"].float(), want["out"].float()
            bar = (torch.maximum(_bf16_ulp(torch, b), torch.full_like(b, OUT_ATOL))
                   if got["out"].dtype == torch.bfloat16 else OUT_ATOL)
            over = ((a - b).abs() / bar).max().item()
            ok = over <= 1.0
            rep[name] = {"max_abs_err": abs_err, "max_err_over_bar": over}
        else:
            ok = max(errs.values()) <= GRAD_RTOL
            rep[name] = {"max_abs_err": abs_err, "grad_rel_fro": errs}
        rep[name]["ok"] = ok
        del got, again, want
    return rep


PRE_KEYS = ("w1", "b1", "s1", "t1", "w2", "b2", "s2", "t2", "w3", "b3", "s3", "t3")
# The per-op chain's pre-attention gradients against K7's: preattn's backward
# takes y's cotangent in bf16, the bf16 sum of three bf16 cotangents (pool,
# gates, tokens), where K7 keeps that sum in f32; the bias and LN sums over
# 133120 tokens carry that rounding (1.0-1.7% seen at rates 0.1/0.25). Held
# here, with a rate-0 run beside it (the floor without masks) and a control
# whose masks are another row's, which must miss it.
PRE_CHAIN_RTOL = 3e-2


def _perop_chain_vs_fused(torch, w, x, rates, gen, seed=99, row_offset=65, chain_offset=0):
    """The per-op chain preattn -> gated_logits -> plain softmax pool ->
    linear_tok (kernels 15-20 through autograd, rows from row_offset +
    chain_offset) against K6/K7 (rows from row_offset) on the same x and
    seed, with a random pooled cotangent and dtok. Returns the errors and
    the keys that miss their bars: pooled at POOLED_ATOL, tokens at
    OUT_ATOL, the gate and token-projector gradients at GRAD_RTOL relative
    Frobenius, the 12 pre-attention ones at PRE_CHAIN_RTOL. bc's exact
    gradient is 0 (softmax is shift invariant): the chain's is held to it at
    BC_ATOL; K7's carries the bf16 rounding of its saved u3 (its y32 in the
    backward is not the forward's) and is reported."""
    from madeleine_torch.ops import encoder_train as et
    from madeleine_torch.ops import gated_logits as gl
    from madeleine_torch.ops import linear_tok as lt
    from madeleine_torch.ops import preattn as pa
    from madeleine_torch.ops.attn_pool import softmax_pool_plain

    b, t, _ = x.shape
    nh, _, e = w["wa"].shape
    bias = et.token_mask_bias(None, b, t, "cuda")
    pooled32, m, s, tok, l, saved = et.encoder_train_fwd_cuda(x, bias, w, seed, row_offset,
                                                              *rates)
    G = torch.from_numpy(gen.standard_normal((b, nh * e)).astype(np.float32)).cuda()
    DT = torch.from_numpy(gen.standard_normal((b, t, w["wt"].shape[0])).astype(np.float32)
                          ).cuda().to(torch.bfloat16)
    inner = (G * pooled32).reshape(b, nh, e).sum(-1)
    k7 = et.encoder_train_bwd_cuda(x, l, m, s, G, inner, DT, saved, w, seed, row_offset, *rates)
    del saved
    ro = row_offset + chain_offset
    wl = {k: v.detach().clone().requires_grad_(True) for k, v in w.items()}
    with torch.enable_grad():
        y = pa.preattn_train(x, wl, seed, ro, rates[0])
        logits = gl.gated_logits_train(y, wl, seed, ro, rates[1])
        pooled = softmax_pool_plain(logits, y.reshape(b, t, nh, e))
        tok_c = lt.linear_tok_train(y, wl["wt"], wl["bt"])
        ((pooled * G).sum() + (tok_c.float() * DT.float()).sum()).backward()
    torch.cuda.synchronize()
    rep = {"pooled_err": (pooled.detach() - pooled32).abs().max().item(),
           "tok_err": (tok_c.detach().float() - tok.float()).abs().max().item(),
           "grad_rel_fro": {k: _rel_fro(wl[k].grad.float(), k7[k].float())
                            for k in w if k != "bc"},
           "chain_bc_max_abs": wl["bc"].grad.abs().max().item(),
           "k7_bc_max_abs": k7["bc"].abs().max().item()}
    rep["failed"] = ([k for k, v in rep["grad_rel_fro"].items()
                      if not v <= (PRE_CHAIN_RTOL if k in PRE_KEYS else GRAD_RTOL)]
                     + [k for k, bar in (("pooled_err", POOLED_ATOL), ("tok_err", OUT_ATOL),
                                         ("chain_bc_max_abs", BC_ATOL)) if not rep[k] <= bar])
    return rep


def phase_perop_kernels(state):
    """Kernels 15-20 against their plain versions, the per-op chain against
    K6/K7, and their times at the train step's call shape."""
    import torch
    import torch.nn.functional as F
    from madeleine_torch.models.madeleine import train_weights

    gen = np.random.default_rng(SEED + 9)
    real = (0.1, 0.25)

    def operands(stain_encoding=False):
        model = flagship_model(torch, "bfloat16", stain_encoding)
        with torch.no_grad():
            return {k: v.detach().contiguous()
                    for k, v in train_weights(model, torch.bfloat16).items()}

    def inputs(b, t, d=512):
        return torch.from_numpy(gen.standard_normal((b, t, d)).astype(np.float32)).cuda().to(
            torch.bfloat16)

    w = operands()
    checks, errs = {}, {k: 0.0 for k in PEROP_KERNELS}
    step_calls = None
    for shape in PEROP_SHAPES:
        x = inputs(*shape)
        for rates in ((0.0, 0.0), real):
            where = f"{list(shape)} {rates}"
            calls = _perop_calls(torch, w, x, rates, gen)
            checks[where] = _check_perop(torch, calls, where)
            if shape == PEROP_STEP_SHAPE and rates == real:
                step_calls = calls
            else:
                del calls
        del x
    # the stain-encoded call: d_in 544 with preattn's dx
    w_se = operands(stain_encoding=True)
    x_se = inputs(*PEROP_STEP_SHAPE, 544)
    se_calls = _perop_calls(torch, w_se, x_se, real, gen, need_dx=True)
    checks["step_call_544_dx"] = _check_perop(
        torch, {"preattn_bwd": se_calls["preattn_bwd"]}, "d_in 544")
    del se_calls, x_se, w_se
    for rep in checks.values():
        for k, r in rep.items():
            errs[k] = max(errs[k], r["max_abs_err"])
    # the chain against K6/K7 at the real rates, at 0 (no masks: the rounding
    # floor, reported), and a control whose masks are the next row's, which
    # must miss the pooled and every pre-attention bar
    x = inputs(*PEROP_STEP_SHAPE)
    chain = {"real": _perop_chain_vs_fused(torch, w, x, real, gen),
             "rates_0": _perop_chain_vs_fused(torch, w, x, (0.0, 0.0), gen),
             "control_rows_shifted": _perop_chain_vs_fused(torch, w, x, real, gen,
                                                           chain_offset=1)}
    del x

    # times at the step's call shape, the real rates
    work = _perop_work(*PEROP_STEP_SHAPE, w)
    times = {}
    for name, (kern, plain, args, kw) in step_calls.items():
        ms = cuda_ms(lambda: kern(*args, **kw))
        with torch.no_grad():
            plain_ms = cuda_ms(lambda: plain(*args, **kw), warmup=1, iters=3)
        bound, by = _bound(*work[name])
        times[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                       "share_of_bound": bound / ms, "gflop": work[name][0] / 1e9,
                       "gb": work[name][1] / 1e9}
    y, wt, bt = step_calls["linear_tok_fwd"][2]
    bt16 = bt.to(torch.bfloat16)
    times["linear_tok_fwd"]["library_ms"] = cuda_ms(lambda: F.linear(y, wt, bt16))
    lib_err = (F.linear(y, wt, bt16).float() - step_calls["linear_tok_fwd"][0](y, wt, bt).float()
               ).abs().max().item()
    del step_calls, y, wt, bt, bt16
    for name in PEROP_KERNELS:
        src, replaces = PEROP_SOURCES[name]
        tm = times[name]
        state.setdefault("kernels", {})[name] = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "max_abs_err": errs[name], "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": tm.get("library_ms")}
    emit({"phase": "perop_kernels", "atol_out": OUT_ATOL, "grad_rtol_fro": GRAD_RTOL,
          "pooled_atol": POOLED_ATOL, "bc_atol": BC_ATOL, "checks": checks,
          "pre_chain_rtol_fro": PRE_CHAIN_RTOL, "chain_vs_k6_k7": chain,
          "times_shape": PEROP_STEP_SHAPE, "times": times, "f_linear_vs_kernel_max_abs": lib_err})
    failed = [(where, k) for where, rep in checks.items() for k, r in rep.items()
              if not r["ok"]]
    control_missed = set(chain["control_rows_shifted"]["failed"])
    if (failed or chain["real"]["failed"]
            or not {"pooled_err"} | set(PRE_KEYS) <= control_missed):
        raise AssertionError(f"perop_kernels: missed their bars: {failed}; the chain against "
                             f"K6/K7: {chain['real']['failed']}; the shifted-mask control "
                             f"missed only {sorted(control_missed)}")


def phase_golden(state):
    import torch
    from madeleine_torch.models.factory import create_model_from_pretrained
    from madeleine_torch.models.madeleine import encode, encode_he, forward_train

    gold = np.load(os.path.join(HERE, "tests", "golden", "golden_flagship.npz"))
    x = torch.from_numpy(gold["fs/encode_he/in"]).cuda()
    want = gold["fs/encode_he/out"]
    out = {"phase": "golden"}
    with tempfile.TemporaryDirectory() as root:
        for precision, dtype, kernel in (("float32", torch.float32, "gated_pool"),
                                         ("bfloat16", torch.bfloat16, "encode_fused")):
            d = write_model_dir(os.path.join(root, precision), precision)
            cfg, model, cdt = create_model_from_pretrained(d, download=False, device="cuda")
            if cdt != dtype:
                raise AssertionError(f"golden {precision}: compute dtype {cdt}")
            before = read_counts()[kernel]
            got = encode_he(model, x.to(dtype)).float().cpu().numpy()
            launched = read_counts()[kernel] - before
            if launched < 1:
                raise AssertionError(f"golden {precision}: {kernel} was not launched")
            rtol, atol = (1e-4, 1e-5) if dtype == torch.float32 else (0.0, 3e-2)
            np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                       err_msg=f"golden {precision}")
            out[precision] = {"kernel": kernel, "max_abs_err": float(np.abs(got - want).max()),
                              "rtol": rtol, "atol": atol}
        # stain codes 3 and 1 (d_in 544) through K2 in f32 and K1 in bf16
        x_se = torch.from_numpy(gold["se/eval/in"][:, 0]).cuda()
        for precision, dtype, kernel in (("float32", torch.float32, "gated_pool"),
                                         ("bfloat16", torch.bfloat16, "encode_fused")):
            d = write_model_dir(os.path.join(root, "se_" + precision), precision, True)
            _, model, _ = create_model_from_pretrained(d, download=False, device="cuda")
            rtol, atol = (1e-4, 1e-5) if dtype == torch.float32 else (0.0, 3e-2)
            rec = {"kernel": kernel, "rtol": rtol, "atol": atol, "d_in": model.cfg.input_dim}
            for idx in (3, 1):
                before = read_counts()[kernel]
                got = encode(model, x_se.to(dtype), stain_idx=idx).float().cpu().numpy()
                if read_counts()[kernel] - before < 1:
                    raise AssertionError(f"golden se/eval/{idx} {precision}: {kernel} was not "
                                         "launched")
                want = gold[f"se/eval/{idx}"].squeeze(1)
                np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                           err_msg=f"golden se/eval/{idx} {precision}")
                rec[f"max_abs_err_stain_{idx}"] = float(np.abs(got - want).max())
            out[f"se_eval_{precision}"] = rec
    # the eval forward in f32 (K3 for every modality's pool) against the
    # reference model's activations, without and with stain encodings
    for prefix, se in (("fs", False), ("se", True)):
        model = flagship_model(torch, "float32", se)
        feats = torch.from_numpy(gold[f"{prefix}/train/in"]).cuda()
        before = read_counts()["attn_pool"]
        slide, tok = forward_train(model, feats, train=False)
        launched = read_counts()["attn_pool"] - before
        if launched != model.cfg.n_modalities:
            raise AssertionError(f"golden {prefix}/train: attn_pool launched {launched} times")
        errs = []
        for idx, mod in enumerate(model.cfg.MODALITIES):
            for got, key in ((slide[:, idx], "wsi"), (tok[:, idx], "tok")):
                want = gold[f"{prefix}/train/{key}/{mod}"]
                want = want[..., 0] if mod == "HE" else want
                got = got.float().cpu().numpy()
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                           err_msg=f"golden {prefix}/train/{key}/{mod}")
                errs.append(float(np.abs(got - want).max()))
        out[f"{prefix}_train_eval_forward_float32"] = {
            "kernel": "attn_pool", "launches": launched, "max_abs_err": max(errs),
            "rtol": 1e-4, "atol": 1e-5}
    emit(out)


def phase_serve(state):
    import torch
    from http.server import ThreadingHTTPServer
    from madeleine_torch.models.factory import create_model_from_pretrained
    from madeleine_torch.models.madeleine import encode_he
    from madeleine_torch.serve.server import EmbeddingService, make_handler

    gen = np.random.default_rng(SEED + 1)
    lengths = [300, 9000, 450, 1000, 1800, 2047, 2600, 3900, 5000, 700, 8000, 1200,
               4100, 333, 6500, 999]
    bags = [gen.standard_normal((n, 512)).astype(np.float32) for n in lengths]
    with tempfile.TemporaryDirectory() as root:
        d = write_model_dir(root, "bfloat16")
        _, model, _ = create_model_from_pretrained(d, download=False, device="cuda")
    svc = EmbeddingService(model, max_batch=32, max_wait_ms=50.0, device="cuda")
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(svc))
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    results = [None] * len(bags)

    def post(i):
        buf = io.BytesIO()
        np.savez(buf, features=bags[i])
        req = urllib.request.Request(url + "/encode", data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            results[i] = np.asarray(json.loads(r.read())["embedding"], np.float32)

    try:
        svc.encode(bags[0])  # first call: allocator warm-up, not timed
        with svc._stats_lock:
            svc._latencies.clear()
        reset_counts()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=post, args=(i,)) for i in range(len(bags))]
        for th_ in threads:
            th_.start()
        for th_ in threads:
            th_.join()
        wall = time.perf_counter() - t0
        counts = read_counts()
        stats = svc.stats()
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
    if counts["encode_fused"] < 1:
        raise AssertionError(f"serve: encode_fused was not launched ({counts})")
    state["launches_serve"] = counts
    max_err = 0.0
    for bag, got in zip(bags, results):
        if got is None:
            raise AssertionError("serve: a request got no answer")
        want = encode_he(model, torch.from_numpy(bag)[None].cuda().to(torch.bfloat16))
        want = want.float().cpu().numpy()[0]
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg="serve vs direct")
        max_err = max(max_err, float(np.abs(got - want).max()))
    emit({"phase": "serve", "requests": len(bags), "buckets": sorted({svc._bucket_of(n)
                                                                       for n in lengths}),
          "wall_s": wall, "slides_per_s": len(bags) / wall,
          "latency_p50_ms": stats["latency_p50_ms"], "latency_p95_ms": stats["latency_p95_ms"],
          "batches": stats["batches"], "launches": counts, "max_abs_err_vs_direct": max_err,
          "healthz": health["status"]})


def phase_extract(state):
    from madeleine_torch.cli import extract_slide_embeddings
    from madeleine_torch.utils.file_utils import load_pkl

    gen = np.random.default_rng(SEED + 2)
    lengths = [int(n) for n in gen.integers(300, 9000, size=16)]
    with tempfile.TemporaryDirectory() as root:
        write_model_dir(os.path.join(root, "models"), "float32")
        bag_dir = os.path.join(root, "cohort", "patch_embeddings")
        os.makedirs(bag_dir)
        for i, n in enumerate(lengths):
            np.savez(os.path.join(bag_dir, f"slide_{i:02d}.npz"),
                     features=gen.standard_normal((n, 512)).astype(np.float32))
        reset_counts()
        t0 = time.perf_counter()
        pkl = extract_slide_embeddings.main([
            "--local_dir", os.path.join(root, "cohort"),
            "--model_dir", os.path.join(root, "models"), "--no_download", "--device", "cuda"])
        wall = time.perf_counter() - t0
        counts = read_counts()
        res = load_pkl(pkl)
    if counts["gated_pool"] < 1:
        raise AssertionError(f"extract: gated_pool was not launched ({counts})")
    state["launches_extract"] = counts
    emb, ids = res["embeds"], res["slide_ids"]
    if set(res) != {"embeds", "slide_ids"} or emb.shape != (16, 512) \
            or sorted(ids) != [f"slide_{i:02d}" for i in range(16)] \
            or not np.isfinite(emb).all():
        raise AssertionError(f"extract: bad pkl {set(res)} {emb.shape} {ids}")
    emit({"phase": "extract", "slides": len(ids), "wall_s": wall,
          "slides_per_s": len(ids) / wall, "launches": counts})


EVAL_REL_FRO = 2e-2   # bf16 eval forward against the f32 model's: a few bf16 roundings
EVAL_CHECK_CASES = 4


def phase_eval_forward(state):
    """forward_train(train=False) at full width in bf16: the MLP and gates
    as plain PyTorch, each modality's pool in K3."""
    import torch
    from madeleine_torch.models.madeleine import forward_train

    cfg = train_path_config()
    model = flagship_model(torch, "bfloat16")
    feats = synthetic_train_batch(torch, cfg, SEED + 8)["feats"]
    forward_train(model, feats, train=False)            # allocator warm-up, not counted
    torch.cuda.synchronize()
    reset_counts()
    slide, tok = forward_train(model, feats, train=False)
    torch.cuda.synchronize()
    counts = read_counts()
    state["launches_eval_forward"] = counts
    n_mod = cfg.n_modalities
    if counts["attn_pool"] != n_mod:
        raise AssertionError(f"eval_forward: attn_pool launched {counts['attn_pool']} times, "
                             f"not once per modality ({counts})")
    bs, t = cfg.batch_size, cfg.n_subsamples
    if tuple(slide.shape) != (bs, n_mod, 1, cfg.embed_dim) \
            or tuple(tok.shape) != (bs, n_mod, t, cfg.token_proj_dim) \
            or not (torch.isfinite(slide.float()).all() and torch.isfinite(tok.float()).all()):
        raise AssertionError(f"eval_forward: outputs {tuple(slide.shape)} {tuple(tok.shape)}")
    ms = cuda_ms(lambda: forward_train(model, feats, train=False), warmup=1, iters=5)
    k3_ms = state.get("kernels", {}).get("attn_pool", {}).get("ms")
    # the first cases against the f32 model's eval forward on the same feats
    model32 = flagship_model(torch, "float32")
    x = feats[:EVAL_CHECK_CASES]
    want_s, want_t = forward_train(model32, x.float(), train=False)
    errs = {"slide_rel_fro": _rel_fro(slide[:EVAL_CHECK_CASES].float(), want_s),
            "tokens_rel_fro": _rel_fro(tok[:EVAL_CHECK_CASES].float(), want_t)}
    emit({"phase": "eval_forward", "batch": list(feats.shape), "launches": counts,
          "ms": ms, "k3_ms_per_call": k3_ms,
          "k3_share": None if k3_ms is None else n_mod * k3_ms / ms,
          "vs_f32_cases": EVAL_CHECK_CASES, "rel_fro_bar": EVAL_REL_FRO, **errs})
    if not max(errs.values()) <= EVAL_REL_FRO:
        raise AssertionError(f"eval_forward: bf16 against f32 {errs} > {EVAL_REL_FRO}")


TRAIN_STEPS = 5
TRAIN_SIGNAL = 0.015  # per-case vector shared by a case's bags (alignment is learnable)


def train_path_config(**overrides):
    """The canonical pretraining run's settings at full width (ref:
    scripts/launch_pretrain_withoutStainEncodings.sh), InfoNCE only (the CLI's
    default --local_loss -1), warmup off so the learning rate is not ~1e-9."""
    from madeleine_torch.config import MadeleineConfig

    return MadeleineConfig.from_dict(dict(dict(
        flagship_config("bfloat16"), local_loss="-1", global_loss="info-nce",
        symmetric_cl=True, temperature=0.001, lr=1e-4, end_learning_rate=1e-8,
        weight_decay=0.01, warmup=False, max_epochs=120, batch_size=65, n_subsamples=2048,
        modality_scan=True), **overrides))


def synthetic_train_batch(torch, cfg, seed: int, signal: float = TRAIN_SIGNAL):
    """[bs, n_mod, t, d] bf16 on the card, made from `seed` on the card: noise
    plus a per-case vector shared by every stain of the case; every stain
    present."""
    bs, n_mod, t, d = cfg.batch_size, cfg.n_modalities, cfg.n_subsamples, cfg.patch_embedding_dim
    g = torch.Generator(device="cuda").manual_seed(seed)
    case = torch.randn(bs, 1, 1, d, generator=g, device="cuda")
    feats = torch.randn(bs, n_mod, t, d, generator=g, device="cuda").add_(signal * case)
    return {"feats": feats.to(torch.bfloat16),
            "modality_labels": torch.ones(bs, n_mod, device="cuda"),
            "sample_mask": torch.ones(bs, dtype=torch.bool, device="cuda")}


def got_path_config(**overrides):
    """The canonical run's published objective, `--local_loss got`
    (scripts/launch_pretrain_withoutStainEncodings.sh:19): InfoNCE + GOT at
    weight 1 with 256 tokens subsampled per stain pair."""
    return train_path_config(**dict(dict(local_loss="got", local_loss_weight=1.0,
                                         got_subsample=256), **overrides))


def _train_setup(torch, cfg=None):
    """(cfg, model, step, batch): the path's model from SEED, its AdamW and
    train step, and one synthetic full-width batch."""
    from madeleine_torch.models.factory import create_model
    from madeleine_torch.train.optim import make_optimizer
    from madeleine_torch.train.trainer import make_train_step

    cfg = train_path_config() if cfg is None else cfg
    _, model = create_model(cfg, seed=SEED, device="cuda")
    opt, sched = make_optimizer(cfg, model.parameters(), steps_per_epoch=TRAIN_STEPS)
    return cfg, model, make_train_step(cfg, model, opt, sched), synthetic_train_batch(
        torch, cfg, SEED + 4)


ENCODER_KERNELS = ("encoder_train_fwd", "encoder_train_bwd")
GOT_KERNELS = ("ipot_fwd", "ipot_bwd", "gw_gamma")


def _run_train_steps(torch, state, phase, kernels, cfg=None):
    """TRAIN_STEPS steps of make_train_step at full width on one fixed batch,
    the counts set to 0 just before: fails unless no step is skipped, every
    loss is finite, the last is below the first and each of `kernels`
    launches on every step. Returns (cfg, model, batch, summary)."""
    from madeleine_torch.train.trainer import step_seed

    cfg, model, step, batch = _train_setup(torch, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, skipped, step_ms, per_step = [], [], [], []
    for i in range(TRAIN_STEPS):
        before = read_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        _, metrics = step(batch, step_seed(SEED, 0, i))
        end.record()
        end.synchronize()
        after = read_counts()
        per_step.append({k: after[k] - before[k] for k in kernels})
        step_ms.append(start.elapsed_time(end))
        losses.append(float(metrics["loss"]))
        skipped.append(bool(metrics["skipped"]))
        emit({"phase": phase, "step": i, "loss": losses[-1], "skipped": skipped[-1],
              "lr": metrics["lr"], "step_ms": step_ms[-1], "launches": per_step[-1]})
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    state[f"launches_{phase}"] = counts
    if any(skipped) or not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{phase}: skipped {skipped}, losses {losses}")
    missing = [(i, k) for i, c in enumerate(per_step) for k in kernels if c[k] < 1]
    if missing:
        raise AssertionError(f"{phase}: kernels not launched on every step: {missing}")
    return cfg, model, batch, {
        "steps": TRAIN_STEPS, "batch": [cfg.batch_size, cfg.n_modalities, cfg.n_subsamples,
                                        cfg.patch_embedding_dim],
        "losses": losses, "skipped": skipped, "step_ms": step_ms,
        "step_ms_median_after_first": statistics.median(step_ms[1:]),
        "peak_memory_gb": peak / 1e9, "launches": counts, "launches_per_step": per_step}


def phase_train(state):
    """The InfoNCE train step (kernels K6/K7 for the encoder), then K6 and K7
    alone at the path's call shape."""
    import torch
    from madeleine_torch.ops import encoder_train as et

    cfg, model, batch, run = _run_train_steps(torch, state, "train", ENCODER_KERNELS)
    with torch.no_grad():
        from madeleine_torch.models.madeleine import train_weights

        w = {k: v.detach().contiguous() for k, v in train_weights(model, torch.bfloat16).items()}
        x = batch["feats"][:, 0].contiguous()
        bias = et.token_mask_bias(None, x.shape[0], x.shape[1], "cuda")
        rates = (et.PRE_RATE, et.GATE_RATE)
        pooled32, m, s, _, l, saved = et.encoder_train_fwd_cuda(x, bias, w, 1, 0, *rates)
        g = torch.randn_like(pooled32)
        inner = (g * pooled32).reshape(x.shape[0], cfg.n_heads, -1).sum(-1)
        dtok = torch.zeros(*x.shape[:2], w["wt"].shape[0], device="cuda", dtype=torch.bfloat16)
        args = (x, l, m, s, g, inner, dtok, saved, w, 1, 0, *rates)
        k6 = cuda_ms(lambda: et.encoder_train_fwd_cuda(x, bias, w, 1, 0, *rates))
        k7 = cuda_ms(lambda: et.encoder_train_bwd_cuda(*args))
    n_mod = cfg.n_modalities
    ff, fb, bf, bb = _encoder_train_work(x.shape[0], x.shape[1], w)
    steady = run["step_ms_median_after_first"]
    emit({"phase": "train", **run, "k6_ms_call": k6, "k7_ms_call": k7,
          "encoder_ms_per_step": n_mod * (k6 + k7),
          "encoder_share_of_step": n_mod * (k6 + k7) / steady,
          "encoder_bound_ms_per_step": n_mod * (_bound(ff, fb)[0] + _bound(bf, bb)[0])})


def phase_train_got(state):
    """The published objective, InfoNCE + GOT: K6/K7 for the encoder and
    K8/K9/K10 for the 260 transport problems of each step; then the GOT loss
    alone (forward + backward) on tokens of the step's shape."""
    import torch
    from madeleine_torch.ops import losses as L

    cfg, _, _, run = _run_train_steps(torch, state, "train_got",
                                      ENCODER_KERNELS + GOT_KERNELS + GLUE_KERNELS,
                                      got_path_config())
    n_pairs = cfg.n_modalities - 1
    shape = (n_pairs, cfg.batch_size, cfg.got_subsample, cfg.token_proj_dim)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    v = torch.randn(*shape, generator=g, device="cuda").requires_grad_(True)
    q = torch.randn(*shape, generator=g, device="cuda").requires_grad_(True)
    smask = torch.ones(n_pairs, cfg.batch_size, dtype=torch.bool, device="cuda")
    got_ms = cuda_ms(lambda: L.got_loss_multi(v, q, sample_mask=smask).sum().backward(),
                     warmup=1, iters=5)
    # the GOT loss's own peak above its inputs (K9's history included)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    L.got_loss_multi(v, q, sample_mask=smask).sum().backward()
    torch.cuda.synchronize()
    got_peak = torch.cuda.max_memory_allocated() - base
    # device time by kernel of one GOT forward + backward: the glue kernels
    # (K11-K14), the transport kernels (K8-K10) and the rest (cosine costs,
    # thresholds' min/max, gathers)
    got_split = _split_got_rows(_profiled(
        torch, lambda: L.got_loss_multi(v, q, sample_mask=smask).sum().backward()))
    hist = 30 * n_pairs * cfg.batch_size * cfg.got_subsample ** 2 * 4
    emit({"phase": "train_got", **run, "got_problems_per_step": n_pairs * cfg.batch_size,
          "got_subsample": cfg.got_subsample, "k9_history_gb": hist / 1e9,
          "got_loss_own_peak_gb": got_peak / 1e9,
          "got_loss_own_peak_gb_less_k9_history": (got_peak - hist) / 1e9,
          "got_loss_fwd_bwd_ms": got_ms,
          "got_share_of_step": got_ms / run["step_ms_median_after_first"],
          "got_device_ms_by_part": got_split})
    state["train_got_step_ms"] = run["step_ms_median_after_first"]
    state["train_got_peak_gb"] = run["peak_memory_gb"]


def phase_train_se(state):
    """The second published run's step, InfoNCE + GOT with stain encodings
    (scripts/launch_pretrain_withStainEncodings.sh): d_in 544, K7 with dx."""
    import torch
    from madeleine_torch.models.factory import create_model

    cfg, model, _, run = _run_train_steps(torch, state, "train_se",
                                          ENCODER_KERNELS + GOT_KERNELS + GLUE_KERNELS,
                                          got_path_config(add_stain_encoding=True))
    _, init = create_model(cfg, seed=SEED, device="cuda")
    moved = (model.embedding.weight - init.embedding.weight).abs().max().item()
    emit({"phase": "train_se", **run, "d_in": cfg.input_dim, "table_max_abs_move": moved,
          "train_got_step_ms": state.get("train_got_step_ms"),
          "train_got_peak_gb": state.get("train_got_peak_gb")})
    if not moved > 0:
        raise AssertionError("train_se: the stain table did not move")


def _pool_own_peak(torch, cfg, activation):
    """GB the plain masked pool's forward and backward allocate above their
    inputs at one modality's call shape [bs, t, nh, e] bf16 (f32 logits)."""
    from madeleine_torch.ops.attn_pool import masked_attention_pool

    g = torch.Generator(device="cuda").manual_seed(SEED)
    nh, e = cfg.n_heads, cfg.wsi_encoder_hidden_dim
    shape = (cfg.batch_size, cfg.n_subsamples)
    xh = torch.randn(*shape, nh, e, generator=g, device="cuda").to(torch.bfloat16)
    logits = torch.randn(*shape, nh, generator=g, device="cuda")
    xh.requires_grad_(True)
    logits.requires_grad_(True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    masked_attention_pool(xh, logits, None, activation).float().sum().backward()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e9


def phase_train_sigmoid(state):
    """The published objective with --activation sigmoid, the per-op lane
    (JAX madeleine.py:157-172): kernels 15-20 for the encoder and K8-K14 for
    GOT on every step, K6/K7 on none; then one profiled step."""
    import torch

    cfg = got_path_config(activation="sigmoid")
    _, model, _, run = _run_train_steps(torch, state, "train_sigmoid",
                                        PEROP_KERNELS + GOT_KERNELS + GLUE_KERNELS, cfg)
    fused = {k: run["launches"][k] for k in ENCODER_KERNELS}
    if any(fused.values()):
        raise AssertionError(f"train_sigmoid: the whole-encoder kernels launched {fused}")
    del model
    pool_peak = _pool_own_peak(torch, cfg, "sigmoid")
    # one profiled step after two unprofiled ones, as phase_profile does
    _, _, step, batch = _train_setup(torch, cfg)
    for i in range(2):
        step(batch, i)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    seeds = iter((2, 3))

    def one_step():
        start.record()
        step(batch, next(seeds))
        end.record()

    rows = _profiled(torch, one_step)
    busy, wall = sum(r[2] for r in rows), start.elapsed_time(end)
    emit({"phase": "train_sigmoid", **run, "activation": cfg.activation,
          "plain_pool_own_peak_gb": pool_peak,
          "train_got_step_ms": state.get("train_got_step_ms"),
          "train_got_peak_gb": state.get("train_got_peak_gb"),
          "profiled_step": {"wall_ms": wall, "device_busy_ms": busy,
                            "device_idle_share": 1.0 - busy / wall,
                            "by_kernel_ms": [[k, c, ms] for k, c, ms in rows[:24]]}})


PRETRAIN_CASES = 70        # 65 + 5: two steps per epoch, the second padded by 60 masked rows
PRETRAIN_TOKENS = (512, 2561)   # bag lengths; below 2048 the subsample draws with replacement
PRETRAIN_IHC_PRESENT = 0.8
PRETRAIN_DOWNSTREAM = 16


def _write_pretrain_cohort(root, gen):
    """<root>/feats/case{i}_{stain}.npz (512-d f32 bags: noise plus a
    per-case vector shared by the case's bags), <root>/ACROBAT.csv, and
    <root>/downstream/patch_embeddings/*.npz. Returns (bags, bytes)."""
    stains = ["HE", "HER2", "PGR", "KI67", "ER"]
    feats = os.path.join(root, "feats")
    os.makedirs(feats)
    rows, n_bags, n_bytes = [], 0, 0
    for i in range(PRETRAIN_CASES):
        case = gen.standard_normal(512, dtype=np.float32)
        labels = {s: int(s == "HE" or gen.random() < PRETRAIN_IHC_PRESENT) for s in stains}
        for s, present in labels.items():
            if present:
                x = gen.standard_normal((int(gen.integers(*PRETRAIN_TOKENS)), 512),
                                        dtype=np.float32)
                x += TRAIN_SIGNAL * case
                np.savez(os.path.join(feats, f"case{i:02d}_{s}.npz"), features=x)
                n_bags, n_bytes = n_bags + 1, n_bytes + x.nbytes
        rows.append(",".join([f"case{i:02d}"] + [str(labels[s]) for s in stains] + ["train"]))
    with open(os.path.join(root, "ACROBAT.csv"), "w") as f:
        f.write("slide_id," + ",".join(stains) + ",split\n" + "\n".join(rows) + "\n")
    down = os.path.join(root, "downstream", "patch_embeddings")
    os.makedirs(down)
    for i in range(PRETRAIN_DOWNSTREAM):
        np.savez(os.path.join(down, f"slide_{i:02d}.npz"),
                 features=gen.standard_normal((int(gen.integers(300, 4000)), 512),
                                              dtype=np.float32))
    return n_bags, n_bytes


def _pretrain_argv(root, results, max_epochs, *extra):
    """The flags of scripts/launch_pretrain_withoutStainEncodings.sh; with
    --add_stain_encoding in `extra`, those of
    scripts/launch_pretrain_withStainEncodings.sh."""
    return ["--dataset", "ACROBAT", "--csv_fpath", os.path.join(root, "ACROBAT.csv"),
            "--data_root_dir", os.path.join(root, "feats"), "--results_dir", results,
            "--wsi_encoder", "abmil", "--n_heads", "4", "--patch_embedding_dim", "512",
            "--wsi_encoder_hidden_dim", "512", "--activation", "softmax",
            "--global_loss", "info-nce", "--local_loss", "got", "--temperature", "0.001",
            "--symmetric_cl", "--lr", "0.0001", "--batch_size", "65", "--n_subsamples", "2048",
            "--warmup", "--warmup_epochs", "5", "--precision", "bfloat16",
            "--max_epochs", str(max_epochs), "--downstream_dir", os.path.join(root, "downstream"),
            *extra]


def _run_pretrain_cli(argv, log_path):
    """`python -m madeleine_torch.cli.pretrain` as a subprocess from the repo
    root; returns (results dir, metrics records, wall seconds)."""
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.run([sys.executable, "-m", "madeleine_torch.cli.pretrain", *argv],
                              cwd=HERE, stdout=log, stderr=subprocess.STDOUT, timeout=900,
                              env=dict(os.environ, PYTHONPATH=HERE))
    wall = time.perf_counter() - t0
    out = open(log_path).read()
    if proc.returncode != 0:
        raise AssertionError(f"pretrain CLI failed (rc {proc.returncode}):\n{out[-4000:]}")
    results = [ln.split(": ", 1)[1] for ln in out.splitlines()
               if ln.startswith("* Results dir: ")][0]
    with open(os.path.join(results, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    return results, records, wall


PRETRAIN_STEP_KERNELS = ENCODER_KERNELS + GOT_KERNELS + GLUE_KERNELS


def _check_pretrain_run(name, results, records, epochs, kernels=PRETRAIN_STEP_KERNELS,
                        downstream_kernel="encode_fused"):
    """Every step finite, none skipped, `kernels` (K6-K14) launched on every
    step, `downstream_kernel` (K1; None: none, as for a non-softmax model,
    whose eval forward is plain) in the downstream pass, the artifacts
    written. Returns the run's summary."""
    import torch
    from madeleine_torch.utils.file_utils import load_pkl

    ep = [r for r in records if "steps" in r]
    if [r["epoch"] for r in ep] != list(epochs):
        raise AssertionError(f"pretrain {name}: epochs {[r['epoch'] for r in ep]}")
    steps = [s for r in ep for s in r["steps"]]
    bad = [s for s in steps if s["skipped"] or not np.isfinite(s["loss"])
           or any(s["launches"].get(k, 0) < 1 for k in kernels)]
    if bad or len(steps) != 2 * len(ep):
        raise AssertionError(f"pretrain {name}: bad steps {bad} of {len(steps)}")
    down = [r for r in records if "downstream" in r]
    if len(down) != 1 or down[0]["slides"] != PRETRAIN_DOWNSTREAM or (
            downstream_kernel and down[0]["launches"].get(downstream_kernel, 0) < 1):
        raise AssertionError(f"pretrain {name}: downstream pass {down}")
    names = set(os.listdir(results))
    want = {"config.json", "model_config.txt", "model.pt", "model_config.json",
            "downstream.pkl", "train_state", "metrics.jsonl"}
    if not want <= names:
        raise AssertionError(f"pretrain {name}: missing {sorted(want - names)}")
    emb = load_pkl(os.path.join(results, "downstream.pkl"))["embeds"]
    if emb.shape != (PRETRAIN_DOWNSTREAM, 512) or not np.isfinite(emb).all():
        raise AssertionError(f"pretrain {name}: downstream embeds {emb.shape}")
    launched = {}
    for s in steps:
        for k, v in s["launches"].items():
            launched[k] = launched.get(k, 0) + v
    for k, v in down[0]["launches"].items():
        launched[k] = launched.get(k, 0) + v
    sd = torch.load(os.path.join(results, "model.pt"), map_location="cpu")
    return {"epochs": len(ep), "losses": [s["loss"] for s in steps],
            "step_ms": [s["step_ms"] for s in steps], "wait_ms": [s["wait_ms"] for s in steps],
            "loader_ms": [x for r in ep for x in r["loader_ms"]],
            "epoch_time_s": [r["epoch_time"] for r in ep],
            "peak_memory_gb": max(r["peak_memory_gb"] for r in ep),
            "launches": launched}, sd


def _loader_breakdown(root):
    """Host ms of one full-width batch (the first 65 cases), by part: reading
    the bags, the 2048-token subsamples, `collate`, and the pin."""
    import torch
    from madeleine_torch.data.datasets import SlideDataset, collate
    from madeleine_torch.data.io import load_features

    ds = SlideDataset("ACROBAT", os.path.join(root, "ACROBAT.csv"), os.path.join(root, "feats"),
                      ["HE", "HER2", "PGR", "KI67", "ER"], embedding_size=512, sample=2048)
    ms = {"read": 0.0, "subsample": 0.0}
    items = []
    for i in range(65):
        row, feats = ds.rows[i], []
        for s in ds.modalities:
            t0 = time.perf_counter()
            x = (load_features(ds._bag_path(row, s)) if int(row[s]) == 1
                 else np.zeros((2, 512), np.float32))
            t1 = time.perf_counter()
            feats.append(ds.sample_n(x))
            ms["read"] += (t1 - t0) * 1e3
            ms["subsample"] += (time.perf_counter() - t1) * 1e3
        items.append({"feats": feats, "modality_labels": [int(row[s]) for s in ds.modalities],
                      "slide_id": row["slide_id"]})
    t0 = time.perf_counter()
    batch = collate(items)
    t1 = time.perf_counter()
    torch.from_numpy(batch["feats"]).pin_memory()
    ms.update(collate=(t1 - t0) * 1e3, pin=(time.perf_counter() - t1) * 1e3)
    return ms


def _pretrain_trio(root, tag, epochs_a, epochs, *extra):
    """Three CLI runs on the cohort: A epochs_a epochs with --checkpoint_every
    1, B A resumed to `epochs`, C `epochs` straight. Returns (runs, model.pt
    state dicts, wall seconds, resume report); B must equal C bit for bit."""
    import torch

    runs, sds, walls = {}, {}, {}
    resume_from = None
    for name, n in (("A", epochs_a), ("B", epochs), ("C", epochs)):
        more = ("--resume", resume_from) if name == "B" else ()
        results, records, walls[name] = _run_pretrain_cli(
            _pretrain_argv(root, os.path.join(root, tag + name.lower()), n,
                           "--checkpoint_every", "1", *more, *extra),
            os.path.join(root, f"pretrain_{tag}{name.lower()}.log"))
        if name == "A":
            resume_from = os.path.join(results, "train_state")
        first = epochs_a if name == "B" else 0
        runs[name], sds[name] = _check_pretrain_run(tag + name, results, records,
                                                    range(first, n))
    unequal = [k for k in sds["C"] if not torch.equal(sds["B"][k], sds["C"][k])]
    max_diff = max((sds["B"][k] - sds["C"][k]).abs().max().item() for k in sds["C"])
    # the resumed epochs against the uninterrupted ones: the same batches, losses
    n_b = len(runs["B"]["losses"])
    same_losses = runs["B"]["losses"] == runs["C"]["losses"][-n_b:]
    if unequal or not same_losses:
        raise AssertionError(f"pretrain {tag}: resumed run differs from the uninterrupted one: "
                             f"{len(unequal)} tensors, max |diff| {max_diff}")
    return runs, sds, walls, {"resume_bitwise_equal": not unequal,
                              "resume_max_abs_diff": max_diff, "resume_same_losses": same_losses}


def phase_pretrain(state):
    """The pretrain CLI at full width with the launch scripts' flags on one
    synthetic cohort: without stain encodings A 2 epochs with
    --checkpoint_every 1, B A resumed to 3 epochs, C 3 epochs straight; with
    them (--add_stain_encoding) A' 1 epoch, B' A' resumed to 2, C' 2
    straight. B's model.pt must equal C's, B''s C''s. Then one epoch with
    --activation sigmoid (the per-op lane, kernels 15-20)."""
    import torch

    gen = np.random.default_rng(SEED + 7)
    root = tempfile.mkdtemp(prefix="pretrain_")
    try:
        t0 = time.perf_counter()
        n_bags, n_bytes = _write_pretrain_cohort(root, gen)
        cohort_s = time.perf_counter() - t0
        runs, _, walls, resume = _pretrain_trio(root, "", 2, 3)
        runs_se, sds_se, walls_se, resume_se = _pretrain_trio(root, "se_", 1, 2,
                                                              "--add_stain_encoding")
        results, records, wall_sig = _run_pretrain_cli(
            _pretrain_argv(root, os.path.join(root, "sigmoid"), 1, "--activation", "sigmoid",
                           "--checkpoint_every", "1"),
            os.path.join(root, "pretrain_sigmoid.log"))
        run_sig, _ = _check_pretrain_run("sigmoid", results, records, range(1),
                                         kernels=PEROP_KERNELS + GOT_KERNELS + GLUE_KERNELS,
                                         downstream_kernel=None)
        loader_parts = _loader_breakdown(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    table = sds_se["C"]["embedding.weight"]
    if tuple(table.shape) != (5, 32) or sds_se["C"]["wsi_embedders.pre_attn.0.weight"].shape[1] \
            != 544:
        raise AssertionError(f"pretrain se_: model.pt table {tuple(table.shape)}")
    # host -> device copy of one batch's f32 feats from pinned memory
    x = torch.empty(65, 5, 2048, 512, dtype=torch.float32).pin_memory()
    h2d_ms = cuda_ms(lambda: x.to("cuda", non_blocking=True), warmup=2, iters=10)
    del x
    steps_ms = [ms for r in runs.values() for ms in r["step_ms"]]
    loader_ms = [ms for r in runs.values() for ms in r["loader_ms"]]
    epoch_s = [s for r in runs.values() for s in r["epoch_time_s"]]
    loop_busy = sum(steps_ms) / (1e3 * sum(epoch_s))
    every = list(runs.values()) + list(runs_se.values()) + [run_sig]
    state["launches_pretrain"] = {k: sum(r["launches"].get(k, 0) for r in every)
                                  for k in read_counts()}
    emit({"phase": "pretrain", "cases": PRETRAIN_CASES, "bags": n_bags,
          "cohort_gb": n_bytes / 1e9, "cohort_write_s": cohort_s, "runs": runs,
          "cli_wall_s": walls, **resume,
          "loader_host_ms_per_batch_median": statistics.median(loader_ms),
          "loader_host_ms_one_batch_by_part": loader_parts,
          "h2d_ms_per_batch": h2d_ms, "h2d_gb_per_batch": 65 * 5 * 2048 * 512 * 4 / 1e9,
          "cli_step_ms_median": statistics.median(steps_ms),
          "in_memory_step_ms": state.get("train_got_step_ms"),
          "epoch_time_s_median": statistics.median(epoch_s),
          "stream_busy_share_of_epochs": loop_busy,
          "peak_memory_gb": max(r["peak_memory_gb"] for r in runs.values()),
          "stain_encoded": {"runs": runs_se, "cli_wall_s": walls_se, **resume_se,
                            "table_shape": list(table.shape),
                            "cli_step_ms_median": statistics.median(
                                [ms for r in runs_se.values() for ms in r["step_ms"]]),
                            "peak_memory_gb": max(r["peak_memory_gb"]
                                                  for r in runs_se.values())},
          "sigmoid": {"run": run_sig, "cli_wall_s": wall_sig,
                      "cli_step_ms_median": statistics.median(run_sig["step_ms"])}})


# kernel-name prefixes of K8-K10 and of K11-K14 in a profiler trace
TRANSPORT_NAMES = ("ipot_fwd_kernel", "ipot_bwd_kernel", "gw_gamma_kernel")
GLUE_NAMES = ("tb_fwd_kernel", "tb_bwd_kernel", "gwt_fwd_kernel", "gwt_bwd_kernel")


def _kernel_base(name):
    """'(anonymous namespace)::tb_fwd_kernel(float const*, ...' -> 'tb_fwd_kernel'."""
    return name.split("(anonymous namespace)::")[-1].split("(")[0].split("::")[-1]


def _split_got_rows(rows):
    """Device ms of the glue kernels, the transport kernels and everything else."""
    parts = {"glue_kernels_ms": 0.0, "transport_kernels_ms": 0.0, "other_ms": 0.0}
    for name, _, ms in rows:
        base = _kernel_base(name)
        key = ("glue_kernels_ms" if base in GLUE_NAMES else
               "transport_kernels_ms" if base in TRANSPORT_NAMES else "other_ms")
        parts[key] += ms
    return parts


def _profile_rows(prof):
    """[(kernel name, launches, device ms)] of a torch.profiler run, longest first."""
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if us:
            rows.append((ev.key[:90], ev.count, us / 1e3))
    return sorted(rows, key=lambda r: -r[2])


def _profiled(torch, fn):
    """[(kernel, launches, device ms)] of one call of fn, from the second of
    two profiled windows: the first window of a profiler can miss
    the kernels launched at its start (the K6 forward read 0 to 0.015 ms
    that way), so a warm-up window runs first (torch.profiler.schedule)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    return _profile_rows(prof)


def phase_profile(state):
    """Device time by kernel of one K6 and one K7 call at the train step's
    call shape [65, 2048] (torch.profiler, CUDA activity), flagship weights."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from madeleine_torch.models.madeleine import MADELEINE, train_weights
    from madeleine_torch.config import MadeleineConfig
    from madeleine_torch.ops import encoder_train as et

    cfg = MadeleineConfig.from_dict(flagship_config("bfloat16"))
    model = MADELEINE(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in flagship_state_dict().items()})
    with torch.no_grad():
        w = {k: v.detach().contiguous().cuda()
             for k, v in train_weights(model, torch.bfloat16).items()}
        g = torch.Generator(device="cuda").manual_seed(SEED)
        x = torch.randn(65, 2048, 512, generator=g, device="cuda").to(torch.bfloat16)
        bias = et.token_mask_bias(None, 65, 2048, "cuda")
        rates = (et.PRE_RATE, et.GATE_RATE)
        out = {}
        for name in ("fwd", "bwd"):
            def run():
                fwd = et.encoder_train_fwd_cuda(x, bias, w, 1, 0, *rates)
                if name == "bwd":
                    pooled32, m, s, _, l, saved = fwd
                    gp = torch.randn_like(pooled32)
                    inner = (gp * pooled32).reshape(65, 4, -1).sum(-1)
                    dtok = torch.zeros(65, 2048, 128, device="cuda", dtype=torch.bfloat16)
                    torch.cuda.synchronize()
                    return lambda: et.encoder_train_bwd_cuda(x, l, m, s, gp, inner, dtok, saved,
                                                             w, 1, 0, *rates)
                return lambda: et.encoder_train_fwd_cuda(x, bias, w, 1, 0, *rates)
            fn = run()
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:   # a single window
                fn()
                torch.cuda.synchronize()
            single = sum(r[2] for r in _profile_rows(prof))
            rows = _profiled(torch, fn)
            out[name] = {"total_ms": sum(r[2] for r in rows), "single_window_total_ms": single,
                         "by_kernel_ms": [[k, c, ms] for k, c, ms in rows[:16]]}
    del x, w
    # one full-width train step of each objective (after two unprofiled
    # ones): device time by kernel against the step's wall time on the
    # CUDA-event clock
    steps = {}
    for name, cfg in (("train_step", None), ("train_step_got", got_path_config())):
        _, _, step, batch = _train_setup(torch, cfg)
        for i in range(2):
            step(batch, i)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        seeds = iter((2, 3))

        def one_step():   # the CUDA events time the second, profiled window's step
            start.record()
            step(batch, next(seeds))
            end.record()

        rows = _profiled(torch, one_step)
        busy, wall = sum(r[2] for r in rows), start.elapsed_time(end)
        steps[name] = {"wall_ms": wall, "device_busy_ms": busy,
                       "device_idle_share": 1.0 - busy / wall, **_split_got_rows(rows),
                       "by_kernel_ms": [[k, c, ms] for k, c, ms in rows[:24]]}
        del step, batch
    # the eval forward at full width (bf16): device time by kernel, K3's part
    # (its partial kernel and the shared combine, which only K3 runs here)
    from madeleine_torch.models.madeleine import forward_train

    model = flagship_model(torch, "bfloat16")
    feats = synthetic_train_batch(torch, train_path_config(), SEED + 8)["feats"]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def one_eval():
        start.record()
        forward_train(model, feats, train=False)
        end.record()

    rows = _profiled(torch, one_eval)
    busy, wall = sum(r[2] for r in rows), start.elapsed_time(end)
    k3 = sum(ms for k, _, ms in rows
             if _kernel_base(k).startswith(("attn_pool_partial", "pool_combine_kernel")))
    steps["eval_forward"] = {"wall_ms": wall, "device_busy_ms": busy,
                             "device_idle_share": 1.0 - busy / wall, "k3_ms": k3,
                             "by_kernel_ms": [[k, c, ms] for k, c, ms in rows[:24]]}
    emit({"phase": "profile", "shape": [65, 2048, 512], **out, **steps})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    if not os.path.isdir(os.path.join(HERE, "madeleine_torch")):
        print("chip_smoke: madeleine_torch/ not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from madeleine_torch.utils.device import resolve_device

    resolve_device("cuda")
    state = {}
    for p in PHASES:
        if p in phases:
            globals()[f"phase_{p}"](state)
    if phases != list(PHASES):
        emit({"partial": phases})
        return 0

    launches = {k: sum(state[f"launches_{p}"][k] for p in MAIN_PATHS) for k in state["kernels"]}
    for k, n in launches.items():
        if n < 1:
            raise AssertionError(f"{k} was not launched on the main path")
    emit({"kernels": [dict(v, launches=launches[k]) for k, v in state["kernels"].items()]})
    print(state["smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": state["kind"],
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
