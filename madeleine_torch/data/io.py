"""Bag file reading: ``.npz``, ``.bag`` and (when h5py imports) ``.h5``.

Schema: one file per slide holding ``features`` [n, d] (ref:
preprocessing/conch_patch_embedder.py:127-131, datasets/wsi_dataset.py:14-19).
``.bag`` is the JAX package's native format (native/bagio.cpp header): a
40-byte little-endian header ``<IIQQIIQ`` = magic, version, rows, cols,
dtype code, reserved, coords offset, then the row-major payload. The port
reads it with numpy; it keeps its own copy of the header constants.
"""

from __future__ import annotations

import os
import struct
from typing import Iterable, Tuple

import numpy as np

try:
    import h5py
except ImportError:  # the GPU machine has no h5py: use .npz or .bag bags there
    h5py = None

BAG_MAGIC = 0x4741424D  # "MBAG"
BAG_HEADER = struct.Struct("<IIQQIIQ")
BAG_F32, BAG_BF16 = 0, 2


def _read_bag_features(path: str) -> np.ndarray:
    """Pure-numpy .bag reader (native/bagio.py:136-154); bf16 payloads widen
    to f32 exactly."""
    with open(path, "rb") as f:
        magic, version, n, d, code, _, _ = BAG_HEADER.unpack(f.read(BAG_HEADER.size))
        if magic != BAG_MAGIC or version != 1:
            raise ValueError(f"not a bag file: {path}")
        if code == BAG_BF16:
            raw = np.frombuffer(f.read(n * d * 2), np.uint16).reshape(n, d)
            return (raw.astype(np.uint32) << 16).view(np.float32)
        if code != BAG_F32:
            raise ValueError(f"{path}: unknown bag dtype code {code}")
        return np.frombuffer(f.read(n * d * 4), np.float32).reshape(n, d)


def _need_h5py(path: str) -> None:
    if h5py is None:
        raise RuntimeError(f"{path}: h5py is not installed; convert bags to .npz or .bag")


def load_features(path: str, dtype=np.float32) -> np.ndarray:
    """The ``features`` array of one bag -> [n, d] (a leading singleton dim is
    squeezed, as the reference does, wsi_dataset.py:16)."""
    if path.endswith(".bag"):
        feats = _read_bag_features(path)
    elif path.endswith(".npz"):
        with np.load(path) as d:
            feats = d["features"]
    else:
        _need_h5py(path)
        with h5py.File(path, "r") as f:
            feats = f["features"][:]
    feats = np.asarray(feats)
    if feats.ndim == 3 and feats.shape[0] == 1:
        feats = feats[0]
    return feats.astype(dtype, copy=False)


def bag_length(path: str) -> int:
    """Token count of one bag; reads only the header where the format allows."""
    if path.endswith(".bag"):
        with open(path, "rb") as f:
            return int(BAG_HEADER.unpack(f.read(BAG_HEADER.size))[2])
    if path.endswith(".npz"):
        with np.load(path) as d:
            return int(d["features"].shape[0])
    _need_h5py(path)
    with h5py.File(path, "r") as f:
        shape = f["features"].shape
    return int(shape[0] if len(shape) != 3 else shape[1])


def list_bags(directory: str,
              exts: Tuple[str, ...] = (".h5", ".npz", ".bag")) -> Iterable[str]:
    """Bag file names, one per slide id, preferring .bag > .h5 > .npz."""
    priority = {".bag": 0, ".h5": 1, ".npz": 2}
    best: dict = {}
    for fn in os.listdir(directory):
        stem, ext = os.path.splitext(fn)
        if ext not in exts:
            continue
        if stem not in best or priority.get(ext, 9) < priority.get(
                os.path.splitext(best[stem])[1], 9):
            best[stem] = fn
    return sorted(best.values())
