"""Attention heatmaps: per-patch attention mapped back onto the slide (JAX:
madeleine_tpu/eval/heatmap.py).

Consumer of the model's return_attention branch (ref: Model.py:206-216).
The card's machine has no PIL, so the PNG (8-bit RGB) is written with
`zlib` and `struct`, and the nearest-neighbour upscale by an integer
`cell_px` is `np.repeat`; only the `thumbnail=` overlay, which needs PIL's
resize and paste, imports PIL, when asked for.
"""

from __future__ import annotations

import os
import struct
import warnings
import zlib
from typing import Optional, Tuple

import numpy as np

# compact 5-stop viridis-ish ramp
STOPS = np.array([[68, 1, 84], [59, 82, 139], [33, 145, 140],
                  [94, 201, 98], [253, 231, 37]], np.float32)
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def attention_to_grid(
    coords: np.ndarray,           # [n, 2] level-0 (x, y) patch origins
    attention: np.ndarray,        # [n] or [n, n_heads] raw logits or weights
    patch_size: int,
    softmax: bool = True,
) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Scatter attention onto the patch grid -> [rows, cols(, heads)] array
    (NaN where no patch), and the grid's level-0 origin."""
    coords = np.asarray(coords)
    attention = np.asarray(attention, np.float32)
    if attention.ndim == 1:
        attention = attention[:, None]
    if softmax:
        a = attention - attention.max(axis=0, keepdims=True)
        e = np.exp(a)
        attention = e / e.sum(axis=0, keepdims=True)
    cs = coords // patch_size
    c0 = cs.min(axis=0)
    cs = cs - c0
    rows, cols = int(cs[:, 1].max()) + 1, int(cs[:, 0].max()) + 1
    grid = np.full((rows, cols, attention.shape[1]), np.nan, np.float32)
    grid[cs[:, 1], cs[:, 0]] = attention
    return grid, (int(c0[0] * patch_size), int(c0[1] * patch_size))


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an [h, w, 3] uint8 array as an 8-bit RGB PNG (no filter)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def png_size(path: str) -> Tuple[int, int]:
    """(width, height) from a PNG's IHDR; raises if the header is not an
    8-bit RGB PNG's."""
    with open(path, "rb") as f:
        head = f.read(33)
    if head[:8] != PNG_SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG")
    w, h, depth, colour = struct.unpack(">IIBB", head[16:26])
    if (depth, colour) != (8, 2):
        raise ValueError(f"{path}: not 8-bit RGB (depth {depth}, colour type {colour})")
    return w, h


def save_heatmap(
    out_path: str,
    coords: np.ndarray,
    attention: np.ndarray,
    patch_size: int,
    thumbnail: Optional[np.ndarray] = None,  # RGB slide thumbnail to overlay
    head: Optional[int] = None,              # None = mean over heads
    alpha: float = 0.55,
    cell_px: int = 8,
) -> str:
    """Render a heatmap PNG: each cell `cell_px` pixels, colour by the
    ramp, white where no patch."""
    grid, _ = attention_to_grid(coords, attention, patch_size)
    with np.errstate(invalid="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # empty cells are all-NaN
        g = np.nanmean(grid, axis=-1) if head is None else grid[..., head]
    valid = ~np.isnan(g)
    lo = np.nanmin(g) if valid.any() else 0.0
    hi = np.nanmax(g) if valid.any() else 1.0
    norm = np.zeros_like(g)
    norm[valid] = (g[valid] - lo) / max(hi - lo, 1e-12)

    idx = norm * (len(STOPS) - 1)
    i0 = np.clip(idx.astype(int), 0, len(STOPS) - 2)
    frac = (idx - i0)[..., None]
    rgb = (STOPS[i0] * (1 - frac) + STOPS[i0 + 1] * frac).astype(np.uint8)
    rgb[~valid] = 255
    rgb = np.repeat(np.repeat(rgb, cell_px, axis=0), cell_px, axis=1)

    if thumbnail is not None:
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError("save_heatmap(thumbnail=...) needs PIL (Pillow) for the "
                              "thumbnail's resize; it is not installed") from e
        img = Image.fromarray(rgb)
        base = Image.fromarray(np.asarray(thumbnail)).resize(img.size)
        mask_img = Image.fromarray(
            (np.repeat(np.repeat(valid, cell_px, 0), cell_px, 1) * int(alpha * 255)
             ).astype(np.uint8)).resize(img.size, Image.NEAREST)
        base.paste(img, (0, 0), mask_img)
        rgb = np.asarray(base.convert("RGB"))
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    write_png(out_path, rgb)
    return out_path
