"""Where the cluster routes of K10 (GW gamma) and K9 (IPOT backward) spend
their time, on a machine with the card:

    python3 -m madeleine_torch.tools.transport_phases

Copies csrc/gw_gamma.cu, csrc/ipot_bwd.cu and the headers into a temporary
directory, stamps `clock64()` behind a block barrier at the boundaries of
each phase of cluster 0's first block, builds both with nvcc and runs them at
the train step's [260, 256, 256] on costs built as the GOT path builds them.
Prints one JSON line: cycles per IPOT iteration (K10: the sweep, the column
partial with its pushes, the cluster barrier, sigma) and per product k-step
(the fetch and multiply, the stage store and barrier), and K9's replay and
adjoint cycles; the stamps' own barriers add a little to every phase. The
package's kernels are not touched.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
# slots 0-7 hold cycles, slot 8 counts K10's product k-steps
STAMP = """
__device__ unsigned long long phase_cycles[16];
#define PHASE(slot) do { __syncthreads(); if (blockIdx.x == 0 && threadIdx.x == 0) { \\
    const long long now_ = clock64(); \\
    ::madeleine_ipot::cluster::phase_cycles[slot] += now_ - t_; t_ = now_; } } while (0)
#define COUNT(slot) do { if (blockIdx.x == 0 && threadIdx.x == 0) \\
    ::madeleine_ipot::cluster::phase_cycles[slot] += 1; } while (0)
"""
READ = """
extern "C" void phase_read(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, madeleine_ipot::cluster::phase_cycles, sizeof(unsigned long long) * 16);
}
extern "C" void phase_zero() {
  unsigned long long z[16] = {0};
  cudaMemcpyToSymbol(madeleine_ipot::cluster::phase_cycles, z, sizeof(z));
}
"""
# K10's IPOT loop (ipot_loop_fast) and tile product (tile_gemm); K9's replay and adjoint
HEADER_PATCHES = [
    ("namespace cg = cooperative_groups;\n", "namespace cg = cooperative_groups;\n" + STAMP),
    ("  for (int k = 0; k < iters; ++k) {\n    float cacc[JPL];",
     "  long long t_ = clock64();\n  for (int k = 0; k < iters; ++k) {\n    float cacc[JPL];"),
    ("    float* rv = recv + par * recv_stride;\n    lanes_to_part(cacc",
     "    PHASE(0);\n    float* rv = recv + par * recv_stride;\n    lanes_to_part(cacc"),
    ("lanes_to_part(cacc, red, m, [&](int j, float s) { push(cl, rv, r, c, mp, j, s); });\n"
     "    cl.sync();\n",
     "lanes_to_part(cacc, red, m, [&](int j, float s) { push(cl, rv, r, c, mp, j, s); });\n"
     "    PHASE(1);\n    cl.sync();\n    PHASE(2);\n"),
    ("    lane_load(sg, sigma, m);\n    par ^= 1;\n  }",
     "    lane_load(sg, sigma, m);\n    par ^= 1;\n    PHASE(3);\n  }"),
    ("      const int KT = (K + TK - 1) / TK;\n      fetch(0);",
     "      long long t_ = clock64();\n      const int KT = (K + TK - 1) / TK;\n      fetch(0);"),
    ("        if (kt + 1 < KT) put(stage + ((kt + 1) & 1) * TK * (XS + YS));\n        __syncthreads();",
     "        PHASE(4);\n        if (kt + 1 < KT) put(stage + ((kt + 1) & 1) * TK * (XS + YS));\n"
     "        PHASE(5);\n        COUNT(8);"),
]
BWD_PATCHES = [
    ("  // ---- replay: iteration k writes T_k (Tb[0] and the history) -------------\n",
     "  long long t_ = clock64();\n"
     "  // ---- replay: iteration k writes T_k (Tb[0] and the history) -------------\n"),
    ("  // ---- adjoint, last iteration first ---------------------------------------\n",
     "  if (FAST) PHASE(6);\n"
     "  // ---- adjoint, last iteration first ---------------------------------------\n"),
    ("  const float scale = -1.f / beta;\n  for (size_t e = tid; e < nrm; e += cl::CTHREADS)",
     "  if (FAST) PHASE(7);\n  const float scale = -1.f / beta;\n"
     "  for (size_t e = tid; e < nrm; e += cl::CTHREADS)"),
]


def _patch(text, patches):
    for old, new in patches:
        if text.count(old) != 1:
            raise RuntimeError(f"anchor not found once in the sources: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def _build(work):
    for f in os.listdir(CSRC):
        if f.endswith(".cuh"):
            shutil.copy(os.path.join(CSRC, f), work)
    with open(os.path.join(CSRC, "ipot_cluster.cuh")) as f:
        header = _patch(f.read(), HEADER_PATCHES)
    with open(os.path.join(work, "ipot_cluster.cuh"), "w") as f:
        f.write(header)
    libs = {}
    for name, patches in (("gw_gamma", []), ("ipot_bwd", BWD_PATCHES)):
        with open(os.path.join(CSRC, f"{name}.cu")) as f:
            src = _patch(f.read(), patches)
        with open(os.path.join(work, f"{name}.cu"), "w") as f:
            f.write(src + READ)
        nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
        out = os.path.join(work, f"lib{name}.so")
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-shared", "-Xcompiler", "-fPIC", "-o", out,
                        os.path.join(work, f"{name}.cu")], check=True)
        libs[name] = ctypes.CDLL(out)
    return libs


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("transport_phases: needs a CUDA device", file=sys.stderr)
        return 2
    from madeleine_torch.ops import losses as L
    from madeleine_torch.ops.got_glue import cst_plain
    from madeleine_torch.ops.ipot import _round4, transport_route

    b, n, m, iters, outer, gw_iters = 260, 256, 256, 30, 5, 20
    gen = np.random.default_rng(0)
    v = torch.from_numpy(gen.standard_normal((b, n, 128)).astype(np.float32)).cuda()
    q = torch.from_numpy(gen.standard_normal((b, m, 128)).astype(np.float32)).cuda()
    with torch.no_grad():
        C = L._threshold_relu(L.cosine_cost(v, q), None)
        Cs = L._threshold_relu(L.cosine_cost(v, v), None)
        Ct = L._threshold_relu(L.cosine_cost(q, q), None)
        Cst = cst_plain(Cs, Ct)
    c_gw, c_bwd = transport_route("gw_gamma", n, m)[1], transport_route("ipot_bwd", n, m)[1]
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as work:
        libs = _build(work)
        gw = libs["gw_gamma"].gw_gamma_cluster_forward
        gw.argtypes = [P] * 4 + [I] * 4 + [F, F, I, I, P]
        bwd = libs["ipot_bwd"].ipot_bwd_cluster
        bwd.argtypes = [P] * 6 + [I] * 4 + [F, I, P]
        gamma = torch.empty_like(Cst)
        dC = torch.empty_like(C)
        Th = torch.empty(b * iters * c_bwd * _round4(-(-n // c_bwd) * m), device="cuda")
        Dh = torch.empty(b, iters, n, device="cuda")
        Sh = torch.empty(b, c_bwd, iters + 1, m, device="cuda")
        calls = {
            "gw_gamma": (libs["gw_gamma"], lambda: gw(
                Cs.data_ptr(), Ct.data_ptr(), Cst.data_ptr(), gamma.data_ptr(), b, n, m, c_gw,
                0.1, 1.0 / (n * m), outer, gw_iters, stream)),
            "ipot_bwd": (libs["ipot_bwd"], lambda: bwd(
                C.data_ptr(), C.data_ptr(), Th.data_ptr(), Dh.data_ptr(), Sh.data_ptr(),
                dC.data_ptr(), b, n, m, c_bwd, 0.5, iters, stream))}
        report = {"device": torch.cuda.get_device_name(0), "shape": [b, n, m]}
        for name, (lib, call) in calls.items():
            runs = []
            for _ in range(3):
                lib.phase_zero()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                if call() != 0:
                    raise RuntimeError(f"{name} launch failed")
                end.record()
                end.synchronize()
                cyc = (ctypes.c_ulonglong * 16)()
                lib.phase_read(cyc)
                runs.append((start.elapsed_time(end), list(cyc)))
            ms, cyc = runs[-1]
            if name == "gw_gamma":
                n_it, n_k = outer * gw_iters, cyc[8]
                report[name] = {
                    "ms": statistics.median(r[0] for r in runs), "c": c_gw, "product_ksteps": n_k,
                    "cycles_per_ipot_iteration": {
                        "sweep": cyc[0] / n_it, "column_partial_and_push": cyc[1] / n_it,
                        "cluster_barrier": cyc[2] / n_it, "sigma": cyc[3] / n_it},
                    "cycles_per_product_kstep": {"fetch_and_multiply": cyc[4] / n_k,
                                                 "store_and_barrier": cyc[5] / n_k},
                    "cycles_ipot_loop": sum(cyc[:4]), "cycles_products": cyc[4] + cyc[5]}
            else:
                report[name] = {"ms": statistics.median(r[0] for r in runs), "c": c_bwd,
                                "cycles_replay": cyc[6], "cycles_adjoint": cyc[7],
                                "cycles_replay_ipot_loop": sum(cyc[:4])}
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
