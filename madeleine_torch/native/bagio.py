"""ctypes bindings of the host library ``csrc/bagio.cpp``: ``.bag`` readers,
the threaded batch assembler and the subsample draw.

Port of `madeleine_tpu/native/bagio.py` with the same C API and the same
results bit for bit. The library is built with g++ at first use
(`ops/_build.py::load_host`); a failed build raises, and no path falls back
to numpy. The assembler writes into a caller's torch tensor (f32, or bf16
through `bag_assemble_batch_bf16`) through its data pointer, so a batch is
born in its transfer dtype in a pinned buffer without numpy's bf16 type.

The plain versions (`PlainBag`, `assemble_batch_plain`,
`sample_indices_plain`) compute the same functions in numpy and pure Python,
for the tests and the card's checks.

.bag format: see the header of csrc/bagio.cpp; `write_bag_file` and
`convert_to_bag` write it.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from madeleine_torch.data.io import (BAG_BF16, BAG_F32, BAG_HEADER, BAG_MAGIC, load_coords,
                                     load_features)
from madeleine_torch.ops import _build

_lib: Optional[ctypes.CDLL] = None
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {   # name: (argtypes, restype) of the C functions called here
    "bag_open": ([ctypes.c_char_p], _P),
    "bag_rows": ([_P], _I64),
    "bag_cols": ([_P], _I64),
    "bag_close": ([_P], None),
    "bag_gather": ([_P, _P, _I64, _P], None),
    "bag_assemble_batch": ([_P, _I64, _P, _I64, _I64, _P, ctypes.c_int32], None),
    "bag_assemble_batch_bf16": ([_P, _I64, _P, _I64, _I64, _P, ctypes.c_int32], None),
    "bag_sample_indices": ([ctypes.c_uint64, _P, _I64, _I64, _P], None),
}


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed (raises if the build fails)."""
    global _lib
    if _lib is None:
        lib = _build.load_host("bagio")
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# Writers
# ---------------------------------------------------------------------------

def write_bag_file(path: str, features: np.ndarray, coords: Optional[np.ndarray] = None,
                   dtype: str = "float32") -> None:
    """Write a .bag file; dtype float32 or bfloat16 (the f32 values rounded
    half-up to their top 16 bits, ``bits + 0x8000``)."""
    features = np.ascontiguousarray(features)
    n, d = features.shape
    if dtype == "bfloat16":
        code, itemsize = BAG_BF16, 2
        as_u32 = features.astype(np.float32).view(np.uint32)
        payload = ((as_u32 + 0x8000) >> 16).astype(np.uint16).tobytes()
    elif dtype == "float32":
        code, itemsize = BAG_F32, 4
        payload = features.astype(np.float32).tobytes()
    else:
        raise ValueError(f"dtype {dtype!r}: float32 or bfloat16")
    coords_off = BAG_HEADER.size + n * d * itemsize if coords is not None else 0
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(BAG_HEADER.pack(BAG_MAGIC, 1, n, d, code, 0, coords_off))
        f.write(payload)
        if coords is not None:
            f.write(np.ascontiguousarray(coords, np.int64).tobytes())


def convert_to_bag(src_path: str, dst_path: Optional[str] = None,
                   dtype: str = "float32") -> str:
    """One bag (``.npz``, ``.h5`` or ``.bag``) as a .bag file, its coords
    kept where the source has them. Returns the written path."""
    dst_path = dst_path or os.path.splitext(src_path)[0] + ".bag"
    write_bag_file(dst_path, load_features(src_path), load_coords(src_path), dtype=dtype)
    return dst_path


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

class BagReader:
    """One .bag file, memory-mapped by the library."""

    def __init__(self, path: str):
        self.path = path
        self._lib = get_lib()
        h = self._lib.bag_open(path.encode())
        if not h:
            raise IOError(f"cannot open bag: {path}")
        self._handle = ctypes.c_void_p(h)
        self.n_rows = int(self._lib.bag_rows(self._handle))
        self.n_cols = int(self._lib.bag_cols(self._handle))

    def gather(self, idx: np.ndarray) -> np.ndarray:
        """Rows `idx` as f32 [len(idx), n_cols]; rows out of range are zeros."""
        idx = np.ascontiguousarray(idx, np.int64)
        out = np.empty((len(idx), self.n_cols), np.float32)
        self._lib.bag_gather(self._handle, idx.ctypes.data, len(idx), out.ctypes.data)
        return out

    def close(self) -> None:
        if self._handle is not None:
            self._lib.bag_close(self._handle)
            self._handle = None

    def __del__(self):  # noqa: D105
        try:
            self.close()
        except Exception:
            pass


class PlainBag:
    """A .bag file's path and shape, read from its header with no native
    code: what `assemble_batch_plain` takes in place of a BagReader."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            magic, version, n, d, _, _, _ = BAG_HEADER.unpack(f.read(BAG_HEADER.size))
        if magic != BAG_MAGIC or version != 1:
            raise IOError(f"cannot open bag: {path}")
        self.n_rows, self.n_cols = int(n), int(d)

    def close(self) -> None:
        pass


# ---------------------------------------------------------------------------
# Batch assembly and the subsample draw
# ---------------------------------------------------------------------------

OUT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def assemble_batch(readers: Sequence[Optional[BagReader]], indices: np.ndarray, d: int,
                   out: torch.Tensor, n_threads: int = 8) -> torch.Tensor:
    """out[k] = rows indices[k] of readers[k] (None: zeros; a row out of
    range: zeros), gathered on the library's thread pool without the
    interpreter lock. `out` is a contiguous CPU tensor [n_tasks, t, d] (or
    any shape of that many elements), float32, or bfloat16 (f32 rows
    rounded half-up; bf16 rows copied). Returns `out`."""
    indices = np.ascontiguousarray(indices, np.int64)
    n_tasks, t = indices.shape
    if len(readers) != n_tasks:
        raise ValueError(f"{len(readers)} readers for {n_tasks} index rows")
    if out.dtype not in (torch.float32, torch.bfloat16) or out.device.type != "cpu" \
            or not out.is_contiguous() or out.numel() != n_tasks * t * d:
        raise ValueError(f"out must be a contiguous float32 or bfloat16 CPU tensor of "
                         f"{n_tasks * t * d} elements, got {out.dtype} {tuple(out.shape)} "
                         f"on {out.device}")
    for r in readers:
        if r is not None and (r._handle is None or r.n_cols != d):
            raise ValueError(f"{r.path}: closed, or {r.n_cols} columns where d = {d}")
    lib = get_lib()
    handles = (ctypes.c_void_p * n_tasks)(*[None if r is None else r._handle for r in readers])
    fn = lib.bag_assemble_batch_bf16 if out.dtype == torch.bfloat16 else lib.bag_assemble_batch
    fn(handles, n_tasks, indices.ctypes.data, t, d, out.data_ptr(), n_threads)
    return out


def sample_indices(seed: int, n_rows: np.ndarray, t: int) -> np.ndarray:
    """The subsample index matrix [len(n_rows), t] int64, sorted per bag: n
    = 0 draws zeros, n < t draws with replacement, n >= t without (selection
    sampling); the stream is splitmix64 seeded per bag from (seed, bag)."""
    n_rows = np.ascontiguousarray(n_rows, np.int64)
    out = np.empty((len(n_rows), t), np.int64)
    get_lib().bag_sample_indices(seed & _M64, n_rows.ctypes.data, len(n_rows), t,
                                 out.ctypes.data)
    return out


def assemble_batch_plain(readers: Sequence, indices: np.ndarray, d: int,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """`assemble_batch`'s plain version: each bag read whole by numpy
    (`data/io.py`), its rows taken, missing bags and rows out of range
    zero, and for bf16 the f32 values rounded half-up. Returns a new tensor
    [n_tasks, t, d]."""
    n_tasks, t = indices.shape
    out = np.zeros((n_tasks, t, d), np.float32)
    cache: Dict[str, np.ndarray] = {}
    for k, r in enumerate(readers):
        if r is None:
            continue
        if r.path not in cache:
            cache[r.path] = load_features(r.path)
        feats, idx = cache[r.path], np.asarray(indices[k], np.int64)
        ok = (idx >= 0) & (idx < len(feats))
        out[k][ok] = feats[idx[ok]]
    if dtype == torch.bfloat16:
        bits = ((out.view(np.uint32) + np.uint32(0x8000)) >> 16).astype(np.uint16)
        return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(out)


_M64 = (1 << 64) - 1


def sample_indices_plain(seed: int, n_rows: Sequence[int], t: int) -> np.ndarray:
    """`sample_indices`' plain version in Python integers: splitmix64, the
    multiply-shift bounded draw with its 128-bit product, counting sort for
    n < t and selection sampling for n >= t."""
    out = np.zeros((len(n_rows), t), np.int64)
    for k, n in enumerate(int(x) for x in n_rows):
        state = (seed & _M64) ^ ((0xD1342543DE82EF95 * (k + 1)) & _M64)

        def bounded(size):
            nonlocal state
            state = (state + 0x9E3779B97F4A7C15) & _M64
            z = ((state ^ (state >> 30)) * 0xBF58476D1CE4E5B9) & _M64
            z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
            return ((z ^ (z >> 31)) * size) >> 64

        if 0 < n < t:
            counts = [0] * n
            for _ in range(t):
                counts[bounded(n)] += 1
            out[k] = np.repeat(np.arange(n), counts)
        elif n >= t:
            rows, needed = [], t
            for row in range(n):
                if needed == 0:
                    break
                if bounded(n - row) < needed:
                    rows.append(row)
                    needed -= 1
            out[k] = rows
    return out
