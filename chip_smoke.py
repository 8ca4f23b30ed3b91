#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (`madeleine_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py                       # every phase (what CI runs)
    python3 chip_smoke.py --phases device,build,kernels

Phases, one JSON line each; any failure raises and the exit code is non-zero:
  device   card name and the nvidia-smi name/power-limit line
  build    nvcc build of every kernel under madeleine_torch/csrc, timed
  kernels  K1 (encode_fused, bf16) and K2 (gated_pool, f32) at the published
           widths, b=8, t=4096, ragged lengths (one bag empty), plus a
           t=4057 call whose last tile is partial: each held against its
           plain PyTorch version on the card, and timed with CUDA events.
           K1 is checked with the flagship weights and again with peaked
           attention (wc scaled), against a uniform-pool control
  golden   flagship weights saved as model.pt + model_config.json, loaded by
           create_model_from_pretrained; encode_he against
           tests/golden/golden_flagship.npz in f32 (through K2) and bf16 (K1)
  serve    EmbeddingService at bf16 behind the HTTP front: 16 ragged requests
           (300-9000 tokens), each equal to a direct encode; K1 must launch
  extract  the extraction CLI in-process at f32 over 16 .npz bags; K2 must launch
Then a {"kernels": [...]} summary line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Needs CUDA and the repo checkout around it.
"""

from __future__ import annotations

import argparse
import importlib.util
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = ("device", "build", "kernels", "golden", "serve", "extract")
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


def flagship_state_dict():
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
    return mod.flagship_state_dict()


def flagship_config(precision: str) -> dict:
    return {"wsi_encoder": "abmil", "patch_embedding_dim": 512,
            "wsi_encoder_hidden_dim": 512, "attention_hidden_dim": 512, "n_heads": 4,
            "activation": "softmax", "precision": precision, "dataset": "ACROBAT",
            "add_stain_encoding": False}


def write_model_dir(root: str, precision: str) -> str:
    """<root>/MADELEINE/{model.pt, model_config.json} with the flagship weights."""
    import torch

    d = os.path.join(root, "MADELEINE")
    os.makedirs(d, exist_ok=True)
    torch.save({k: torch.from_numpy(v) for k, v in flagship_state_dict().items()},
               os.path.join(d, "model.pt"))
    with open(os.path.join(d, "model_config.json"), "w") as f:
        json.dump(flagship_config(precision), f)
    return d


def reset_counts():
    from madeleine_torch.ops import encode_fused, gated_pool

    encode_fused.launches = 0
    gated_pool.launches = 0


def read_counts() -> dict:
    from madeleine_torch.ops import encode_fused, gated_pool

    return {"encode_fused": encode_fused.launches, "gated_pool": gated_pool.launches}


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
    state["kernels"] = {
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
    }
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


def phase_golden(state):
    import torch
    from madeleine_torch.models.factory import create_model_from_pretrained
    from madeleine_torch.models.madeleine import encode_he

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

    launches = {k: state["launches_serve"][k] + state["launches_extract"][k]
                for k in state["kernels"]}
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
