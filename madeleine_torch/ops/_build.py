"""Build the CUDA kernels under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``csrc/build/lib<name>.so`` with a plain C
interface: no PyTorch headers, so a build takes seconds. Sources are built
at first use (or all at once, in parallel, by `build`), and rebuilt when a
``.cu``/``.cuh`` file is newer than the library. Nothing here runs at import
time: the CPU tests import every module on machines without nvcc.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
KERNELS = ("encode_fused", "gated_pool", "attn_pool", "encoder_train_fwd", "encoder_train_bwd",
           "ipot_fwd", "ipot_bwd", "gw_gamma", "got_glue", "preattn", "gated_logits",
           "linear_tok")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SMEM_LIMIT = 232448   # bytes of shared memory one block may use on Hopper

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels are "
                       "built from madeleine_torch/csrc at first use")


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    so = lib_path(name)
    if not os.path.exists(so):
        return True
    deps = [os.path.join(CSRC, f"{name}.cu")] + [
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh")]
    return max(os.path.getmtime(d) for d in deps) > os.path.getmtime(so)


def build(names: Optional[Iterable[str]] = None, force: bool = False) -> Dict[str, str]:
    """Compile the named kernels (default: all), one nvcc process per source,
    all started together. Returns {name: ptxas report}. Raises on any failure."""
    names = list(KERNELS if names is None else names)
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = lib_path(n) + f".{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for n, (tmp, p) in procs.items():
        out, _ = p.communicate()
        reports[n] = out
        if p.returncode != 0:
            failed.append(f"{n}.cu (rc {p.returncode}):\n{out}")
        else:
            os.replace(tmp, lib_path(n))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def check_operand(kernel: str, name: str, x: torch.Tensor, shape: Sequence[int],
                  dtype: torch.dtype, device: torch.device) -> None:
    """Raise unless x is a contiguous `dtype` tensor of `shape` on `device`:
    the kernels take raw pointers and trust these."""
    if x.device != device or x.dtype != dtype or tuple(x.shape) != tuple(shape) \
            or not x.is_contiguous():
        raise ValueError(f"{kernel} kernel: {name} must be a contiguous {dtype} tensor "
                         f"{tuple(shape)} on {device}, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}{'' if x.is_contiguous() else ' (non-contiguous)'}")


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    with _lock:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(lib_path(name))
        return _libs[name]


def check_problems(kernel: str, operands, shapes, lib_name: str, smem_fn: str, n: int,
                   m: int) -> torch.device:
    """For the per-problem f32 kernels of the GOT loss (one block per [n, m]
    problem): raise unless every (name, tensor) operand is a contiguous f32
    CUDA tensor of its shape on the first operand's device, and the block's
    shared memory (``smem_fn(n, m)`` of the library) fits. Returns the device."""
    dev = operands[0][1].device
    if dev.type != "cuda":
        raise ValueError(f"{kernel} kernel needs CUDA tensors, got {dev}")
    for (name, x), shape in zip(operands, shapes):
        check_operand(kernel, name, x, shape, torch.float32, dev)
    if min(n, m) < 1 or max(shapes[0]) >= 2 ** 31:
        raise ValueError(f"{kernel} kernel: unsupported shape {tuple(shapes[0])}")
    smem = getattr(load(lib_name), smem_fn)
    smem.argtypes, smem.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_size_t
    if smem(n, m) > SMEM_LIMIT:
        raise ValueError(f"{kernel} kernel: n={n}, m={m} need {smem(n, m)} bytes of shared "
                         f"memory per block, above {SMEM_LIMIT}")
    return dev


def launch(lib_name: str, fn_name: str, argtypes, args, device: torch.device) -> None:
    """Call ``fn_name`` of csrc/<lib_name>.cu on the device's current stream:
    tensors pass as their data pointers, the stream last. The C function
    returns the cudaError_t of its launches; non-zero raises."""
    fn = getattr(load(lib_name), fn_name)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args), stream)
    if err != 0:
        raise RuntimeError(f"{lib_name} kernel launch failed: cudaError {err}")


def call_ptrs(lib_name: str, fn_name: str, tensors: Sequence[Optional[torch.Tensor]],
              dims: Sequence[int], scales: Sequence[float], device: torch.device) -> None:
    """Call ``fn_name(void** p, const long long* dims, const float* scales,
    stream)`` of csrc/<lib_name>.cu on the device's current stream: p holds
    the tensors' data pointers (None passes a null pointer). The C function
    returns the cudaError_t of its launches; non-zero raises."""
    fn = getattr(load(lib_name), fn_name)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = [ctypes.c_void_p] * 4, ctypes.c_int
    ptrs = (ctypes.c_void_p * len(tensors))(*(None if x is None else x.data_ptr()
                                              for x in tensors))
    cdims = (ctypes.c_longlong * len(dims))(*dims)
    cscales = (ctypes.c_float * max(1, len(scales)))(*scales)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(ptrs, cdims, cscales, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{lib_name} kernel launch failed: cudaError {err}")


def workspace(lib_name: str, fn_name: str, dims: Sequence[int]) -> Tuple[int, int]:
    """``fn_name(const long long* dims, long long* out)`` of csrc/<lib_name>.cu:
    the floats of (split-K partials, column partials) a backward needs."""
    fn = getattr(load(lib_name), fn_name)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_void_p], None
    out = (ctypes.c_longlong * 2)()
    fn((ctypes.c_longlong * len(dims))(*dims), out)
    return out[0], out[1]


def launch_split_pool(name: str, inputs: Sequence[torch.Tensor], dims: Sequence[int],
                      b: int, t: int, nh: int, E: int, out_dtype: torch.dtype) -> torch.Tensor:
    """Launch ``<name>_forward`` of csrc/<name>.cu on the current stream.

    Both kernels split the tokens into tiles of ``<name>_tile_rows()`` rows,
    write per-tile partials (m [b, ntiles, nh], s [b, ntiles, nh], w
    [b, ntiles, E], f32) and combine them into out [b, E] (pool_combine.cuh).
    The C entry point takes (*inputs, part_m, part_s, part_w, out, *dims,
    stream) and returns the cudaError_t of its launches; non-zero raises."""
    lib = load(name)
    fwd, tile_rows = getattr(lib, f"{name}_forward"), getattr(lib, f"{name}_tile_rows")
    if fwd.argtypes is None:
        fwd.argtypes = ([ctypes.c_void_p] * (len(inputs) + 4) + [ctypes.c_int] * len(dims)
                        + [ctypes.c_void_p])
        fwd.restype = ctypes.c_int
        tile_rows.argtypes = []
        tile_rows.restype = ctypes.c_int
    ntiles = -(-t // tile_rows())
    dev, f32 = inputs[0].device, torch.float32
    part_m = torch.empty(b, ntiles, nh, dtype=f32, device=dev)
    part_s = torch.empty(b, ntiles, nh, dtype=f32, device=dev)
    part_w = torch.empty(b, ntiles, E, dtype=f32, device=dev)
    out = torch.empty(b, E, dtype=out_dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fwd(*(x.data_ptr() for x in inputs), part_m.data_ptr(), part_s.data_ptr(),
                  part_w.data_ptr(), out.data_ptr(), *dims, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    return out
