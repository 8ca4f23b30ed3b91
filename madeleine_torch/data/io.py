"""Bag files: ``.npz``, ``.bag`` and (when h5py imports) ``.h5``, read and written.

Schema: one file per slide holding ``features`` [n, d] (ref:
preprocessing/conch_patch_embedder.py:127-131, datasets/wsi_dataset.py:14-19).
``.bag`` is the JAX package's native format (native/bagio.cpp header): a
40-byte little-endian header ``<IIQQIIQ`` = magic, version, rows, cols,
dtype code, reserved, coords offset, then the row-major payload. This
module reads it with numpy; the native loader (`madeleine_torch/native/`)
maps it through the host library and `native/bagio.py::write_bag_file`
writes it. The writers (`write_bag`, `append_bag`) take the format from the
path's extension and never switch it: a ``.h5`` path without h5py raises.
"""

from __future__ import annotations

import os
import struct
from typing import Iterable, Optional, Tuple

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


BAG_FORMATS = (".h5", ".npz", ".bag")


def need_h5py(path: str) -> None:
    if h5py is None:
        raise RuntimeError(f"{path}: h5py is not installed; use .npz or .bag bags "
                           "(python -m madeleine_torch.cli.convert_bags converts them)")


def load_features(path: str, dtype=np.float32) -> np.ndarray:
    """The ``features`` array of one bag -> [n, d] (a leading singleton dim is
    squeezed, as the reference does, wsi_dataset.py:16)."""
    if path.endswith(".bag"):
        feats = _read_bag_features(path)
    elif path.endswith(".npz"):
        with np.load(path) as d:
            feats = d["features"]
    else:
        need_h5py(path)
        with h5py.File(path, "r") as f:
            feats = f["features"][:]
    feats = np.asarray(feats)
    if feats.ndim == 3 and feats.shape[0] == 1:
        feats = feats[0]
    return feats.astype(dtype, copy=False)


def load_coords(path: str) -> Optional[np.ndarray]:
    """The ``coords`` array [n, 2] of one bag, or None where it has none."""
    if path.endswith(".bag"):
        with open(path, "rb") as f:
            _, _, n, _, _, _, offset = BAG_HEADER.unpack(f.read(BAG_HEADER.size))
            if not offset:
                return None
            f.seek(offset)
            return np.frombuffer(f.read(n * 16), np.int64).reshape(n, 2)
    if path.endswith(".npz"):
        with np.load(path) as d:
            return d["coords"] if "coords" in d.files else None
    need_h5py(path)
    with h5py.File(path, "r") as f:
        return f["coords"][:] if "coords" in f else None


def bag_length(path: str) -> int:
    """Token count of one bag; reads only the header where the format allows."""
    if path.endswith(".bag"):
        with open(path, "rb") as f:
            return int(BAG_HEADER.unpack(f.read(BAG_HEADER.size))[2])
    if path.endswith(".npz"):
        with np.load(path) as d:
            return int(d["features"].shape[0])
    need_h5py(path)
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


def _bag_format(path: str) -> str:
    ext = os.path.splitext(path)[1]
    if ext not in BAG_FORMATS:
        raise ValueError(f"{path}: a bag file is one of {BAG_FORMATS}")
    return ext


def write_bag(path: str, features: np.ndarray, coords: Optional[np.ndarray] = None,
              attrs: Optional[dict] = None) -> None:
    """Write one bag in the reference schema (JAX data/io.py:79-96):
    ``.npz`` by numpy, ``.bag`` as f32 with coords (`write_bag_file`),
    ``.h5`` by h5py (plain datasets, `attrs` as file attributes)."""
    ext = _bag_format(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if ext == ".npz":
        data = {"features": features}
        if coords is not None:
            data["coords"] = coords
        np.savez(path, **data)
    elif ext == ".bag":
        from madeleine_torch.native.bagio import write_bag_file

        write_bag_file(path, features, coords)
    else:
        need_h5py(path)
        with h5py.File(path, "w") as f:
            f.create_dataset("features", data=features)
            if coords is not None:
                f.create_dataset("coords", data=coords)
            for k, v in (attrs or {}).items():
                f.attrs[k] = v


def append_bag(path: str, features: np.ndarray, coords: Optional[np.ndarray] = None) -> None:
    """Append rows to a ``.h5`` bag, creating it if absent: resizable
    datasets chunked by the first append's rows (at most 1024), the
    streaming pattern of the tile embedder (JAX data/io.py:99-118; ref:
    conch_patch_embedder.py:16-66). ``.npz`` and ``.bag`` have fixed
    headers: write them whole with `write_bag`."""
    if _bag_format(path) != ".h5":
        raise ValueError(f"{path}: only .h5 bags take appends; write .npz and .bag whole")
    need_h5py(path)
    first = not os.path.exists(path)
    with h5py.File(path, "a") as f:
        items = {"features": features}
        if coords is not None:
            items["coords"] = coords
        for name, arr in items.items():
            arr = np.asarray(arr)
            if first or name not in f:
                maxshape = (None,) + arr.shape[1:]
                f.create_dataset(name, data=arr, maxshape=maxshape,
                                 chunks=(max(1, min(len(arr), 1024)),) + arr.shape[1:])
            else:
                ds = f[name]
                n0 = ds.shape[0]
                ds.resize(n0 + arr.shape[0], axis=0)
                ds[n0:] = arr
