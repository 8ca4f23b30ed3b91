"""Build the CUDA kernels under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``csrc/build/lib<name>.so`` with a plain C
interface: no PyTorch headers, so a build takes seconds. Sources are built
at first use (or all at once, in parallel, by `build`), and rebuilt when a
``.cu``/``.cuh`` file is newer than the library. The host library
``csrc/bagio.cpp`` (the native ``.bag`` loader, no CUDA) is built the same
way with g++ by `load_host`. Nothing here runs at import time: the CPU
tests import every module on machines without nvcc.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import struct
import subprocess
import threading
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
KERNELS = ("encode_fused", "gated_pool", "attn_pool", "encoder_train_fwd", "encoder_train_bwd",
           "ipot_fwd", "ipot_bwd", "gw_gamma", "got_glue", "preattn", "gated_logits",
           "linear_tok", "dropout", "gemm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_CXX = "g++"     # the host libraries' compiler
HOST_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread")
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
    if x.dtype != dtype or x.shape != tuple(shape) or x.device != device \
            or not x.is_contiguous():
        raise ValueError(f"{kernel} kernel: {name} must be a contiguous {dtype} tensor "
                         f"{tuple(shape)} on {device}, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}{'' if x.is_contiguous() else ' (non-contiguous)'}")


KERNEL_DTYPES = (torch.bfloat16, torch.float32)   # the train kernels' operand types


def check_dtypes(kernel: str, name: str, x: torch.Tensor, w: Dict[str, torch.Tensor],
                 keys: Iterable[str], mats: Iterable[str]) -> torch.dtype:
    """The call's compute dtype, that of its input `name` (x): bf16 or f32,
    with every operand of `keys` that is in `mats` (the matrices) in it and
    every other one (the vectors) f32 on both routes. A mixed set raises a
    ValueError that names the first operand out of line."""
    dt = x.dtype
    if dt not in KERNEL_DTYPES:
        raise ValueError(f"{kernel} kernel: {name} must be bf16 or f32, got {dt}")
    mats = set(mats)
    for k in keys:
        want = dt if k in mats else torch.float32
        if w[k].dtype != want:
            raise ValueError(f"{kernel} kernel: {k} must be {want} with {dt} {name} "
                             f"(a mixed operand set), got {w[k].dtype}")
    return dt


def check_aligned(kernel: str, name: str, x: torch.Tensor) -> None:
    """Raise unless x starts on a 16-byte boundary: TMA and cp.async read
    16-byte aligned rows."""
    if x.data_ptr() % 16:
        raise ValueError(f"{kernel} kernel: {name} must start on a 16-byte boundary, "
                         f"got address {x.data_ptr():#x}")


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed. A CDLL
    releases the interpreter lock around each call, as PyTorch's bindings
    do around each op: a launch that waits (a kernel's first, lazily loaded
    launch, or a full launch queue) leaves the data loader's and the
    server's threads free to run."""
    with _lock:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(lib_path(name))
        return _libs[name]


def build_host(name: str) -> str:
    """Compile the host library ``csrc/<name>.cpp`` with g++ into
    csrc/build/lib<name>.so, unless the library is newer than the source;
    returns its path. The compile writes a temporary file that then
    replaces the library, under a file lock that every process of the
    checkout takes (pytest's worker processes may build at the same time).
    A failed build raises RuntimeError: no path falls back."""
    src, so = os.path.join(CSRC, f"{name}.cpp"), lib_path(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(so + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
            return so
        tmp = f"{so}.{os.getpid()}.tmp"
        try:
            proc = subprocess.run([HOST_CXX, *HOST_FLAGS, src, "-o", tmp],
                                  capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"cannot build {name}.cpp: {HOST_CXX}: {e}") from e
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise RuntimeError(f"{HOST_CXX} failed for {name}.cpp (rc {proc.returncode}):\n"
                               f"{proc.stderr[-4000:]}")
        os.replace(tmp, so)
    return so


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library for csrc/<name>.cpp, built first if needed; a
    CDLL, so each call runs without the interpreter lock."""
    key = name + ".cpp"
    with _lock:
        if key not in _libs:
            _libs[key] = ctypes.CDLL(build_host(name))
        return _libs[key]


_entries: Dict[Tuple[str, str], Any] = {}
_structs: Dict[Tuple[str, int], struct.Struct] = {}


def entry(lib_name: str, fn_name: str, argtypes, restype=ctypes.c_int):
    """The C function ``fn_name`` of csrc/<lib_name>.cu, resolved and given
    its argtypes once; later calls return the same prepared function."""
    fn = _entries.get((lib_name, fn_name))
    if fn is None:
        fn = getattr(load(lib_name), fn_name)
        fn.argtypes, fn.restype = argtypes, restype
        _entries[(lib_name, fn_name)] = fn
    return fn


def _packed(code: str, values) -> bytes:
    """`values` as a C array (``q``: 64-bit ints, ``f``: floats) in a bytes
    object, which ctypes passes to a ``c_void_p`` parameter as a pointer to
    its data; the C side only reads it. Three times cheaper on the host than
    a ctypes array; one struct.Struct per length."""
    key = (code, len(values))
    fmt = _structs.get(key)
    if fmt is None:
        fmt = _structs[key] = struct.Struct(f"{len(values)}{code}")
    return fmt.pack(*values)


def current_stream(index: int) -> int:
    """The raw cudaStream_t of device `index`'s current stream."""
    return torch._C._cuda_getCurrentRawStream(index)


def current_device() -> int:
    """The current CUDA device's index (CUDA is initialised: a tensor lies there)."""
    return torch._C._cuda_getDevice()


def _invoke(lib_name: str, fn, args, device: torch.device) -> None:
    """fn(*args, stream) on the device's current stream, entering the
    device's context only when it is not the current device (a device
    without an index is the current one). A non-zero cudaError_t raises."""
    index, current = device.index, current_device()
    if index is None or index == current:
        err = fn(*args, current_stream(current))
    else:
        with torch.cuda.device(index):
            err = fn(*args, current_stream(index))
    if err != 0:
        raise RuntimeError(f"{lib_name} kernel launch failed: cudaError {err}")


def check_problems(kernel: str, operands, shapes, lib_name: str, smem_fn: str, n: int,
                   m: int, *smem_extra: int) -> torch.device:
    """For the per-problem f32 kernels of the GOT loss (one block, or one
    cluster of blocks, per [n, m] problem): raise unless every (name, tensor)
    operand is a contiguous f32 CUDA tensor of its shape on the first
    operand's device, and the block's shared memory (``smem_fn(n, m,
    *smem_extra)`` of the library) fits. Returns the device."""
    dev = operands[0][1].device
    if dev.type != "cuda":
        raise ValueError(f"{kernel} kernel needs CUDA tensors, got {dev}")
    for (name, x), shape in zip(operands, shapes):
        check_operand(kernel, name, x, shape, torch.float32, dev)
    if min(n, m) < 1 or max(shapes[0]) >= 2 ** 31:
        raise ValueError(f"{kernel} kernel: unsupported shape {tuple(shapes[0])}")
    args = (n, m, *smem_extra)
    smem = entry(lib_name, smem_fn, [ctypes.c_int] * len(args), ctypes.c_size_t)(*args)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{kernel} kernel: n={n}, m={m} need {smem} bytes of shared "
                         f"memory per block, above {SMEM_LIMIT}")
    return dev


def launch(lib_name: str, fn_name: str, argtypes, args, device: torch.device) -> None:
    """Call ``fn_name`` of csrc/<lib_name>.cu on the device's current stream:
    tensors pass as their data pointers, the stream last. The C function
    returns the cudaError_t of its launches; non-zero raises."""
    fn = entry(lib_name, fn_name, argtypes)
    _invoke(lib_name, fn, [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args],
            device)


_PTRS_ARGTYPES = [ctypes.c_void_p] * 4


def call_ptrs(lib_name: str, fn_name: str, tensors: Sequence[Optional[torch.Tensor]],
              dims: Sequence[int], scales: Sequence[float], device: torch.device) -> None:
    """Call ``fn_name(void** p, const long long* dims, const float* scales,
    stream)`` of csrc/<lib_name>.cu on the device's current stream: p holds
    the tensors' data pointers (None passes a null pointer). The C function
    returns the cudaError_t of its launches; non-zero raises."""
    fn = entry(lib_name, fn_name, _PTRS_ARGTYPES)
    ptrs = _packed("q", [0 if x is None else x.data_ptr() for x in tensors])
    _invoke(lib_name, fn, (ptrs, _packed("q", dims), _packed("f", scales or (0.0,))), device)


def workspace(lib_name: str, fn_name: str, dims: Sequence[int], n: int = 2) -> Tuple[int, ...]:
    """``fn_name(const long long* dims, long long* out)`` of csrc/<lib_name>.cu:
    the floats of the n workspaces a call needs (a backward's: split-K
    partials, column partials; K6 / K7 with f32 operands also their weights
    split into TF32 hi and lo)."""
    fn = entry(lib_name, fn_name, [ctypes.c_void_p, ctypes.c_void_p], None)
    out = (ctypes.c_longlong * n)()
    fn(_packed("q", dims), out)
    return tuple(out)


def launch_split_pool(name: str, inputs: Sequence[torch.Tensor], dims: Sequence[int],
                      b: int, t: int, nh: int, E: int, out_dtype: torch.dtype,
                      stats: Sequence[Optional[torch.Tensor]] = (),
                      prefix: Optional[str] = None) -> torch.Tensor:
    """Launch ``<prefix>_forward`` of csrc/<name>.cu on the current stream
    (prefix defaults to name: another prefix reaches a second design kept in
    the same library).

    The kernels split the tokens into tiles of ``<prefix>_tile_rows()`` rows,
    write per-tile partials (m [b, ntiles, nh], s [b, ntiles, nh], w
    [b, ntiles, E], f32) and combine them into out [b, E] (pool_combine.cuh).
    The C entry point takes (*inputs, part_m, part_s, part_w, out, *stats,
    *dims, stream) and returns the cudaError_t of its launches; non-zero
    raises. ``stats`` are further outputs of the merge (attn_pool.cu: m and
    s [b, nh] f32), None passing a null pointer."""
    prefix = prefix or name
    fwd = entry(name, f"{prefix}_forward", [ctypes.c_void_p] * (len(inputs) + 4 + len(stats))
                + [ctypes.c_int] * len(dims) + [ctypes.c_void_p])
    ntiles = -(-t // entry(name, f"{prefix}_tile_rows", [])())
    dev = inputs[0].device
    # the three partials share one f32 buffer, each part on a 256-byte boundary
    sizes = [-(-n // 64) * 64 for n in (b * ntiles * nh, b * ntiles * nh, b * ntiles * E)]
    work = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    out, part = torch.empty(b, E, dtype=out_dtype, device=dev), work.data_ptr()
    _invoke(name, fwd, [*(x.data_ptr() for x in inputs), part, part + 4 * sizes[0],
                        part + 4 * (sizes[0] + sizes[1]), out.data_ptr(),
                        *(None if x is None else x.data_ptr() for x in stats), *dims], dev)
    return out
