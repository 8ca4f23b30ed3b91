"""Tile embedding: a slide's tissue tiles through a patch encoder into a bag
(JAX: madeleine_tpu/preprocessing/tile_embedder.py; ref:
preprocessing/conch_patch_embedder.py).

Encoders take uint8 tiles [n, s, s, 3], a numpy array or a tensor (the
embedder hands them a tensor on their device), and return float32 features
[n, d] (numpy for numpy input, a tensor on the device for a tensor):

- `HandcraftedEncoder`: the JAX package's weightless descriptor, computed on
  the device (its 8 x 8 area pool reproduces cv2.INTER_AREA on uint8 and its
  moments numpy's float32 reductions, bit for bit);
- `TorchPatchEncoder`: any ``nn.Module`` or function on tensors (JAX:
  JaxPatchEncoder);
- `make_conch_encoder`: CONCH through the `conch` package, where installed;
- `preprocessing.vit.TorchViTEncoder`: the ViT tile tower.

`TileEmbedder` plans the tissue grid (`patching.WSIPatcher`), reads each
batch's regions into one pinned host buffer, copies it to the device, resizes
and encodes it there, and writes ``<save_path>/patch_embeddings/<fn>.<ext>``
with the reference's ``features`` [n, d] float32 and ``coords`` [n, 2] int64
(level-0 x, y). ``.h5`` (the JAX package's format, resizable datasets
appended a batch at a time) needs h5py; ``.npz`` and ``.bag`` are written
once, at the end. The device's work on a batch overlaps the host's read of
the next for an encoder that does not wait on the device (the ViT tower,
`TorchPatchEncoder` on a module): `HandcraftedEncoder`'s moments read a
value back to the host on every replay pass (`sequential_sum_f32`), so
with it the host stalls inside each batch and the "encode" timing
includes those stalls.
"""

from __future__ import annotations

import math
import os
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from madeleine_torch.data import io as bag_io
from madeleine_torch.preprocessing.patching import WSIPatcher, mag_to_px_size
from madeleine_torch.preprocessing.wsi import wsi_factory
from madeleine_torch.utils.device import resolve_device

TileEncoder = Callable[..., object]
BAG_FORMATS = tuple(ext[1:] for ext in bag_io.BAG_FORMATS)


# ---------------------------------------------------------------------------
# cv2.INTER_AREA on uint8, on the device
# ---------------------------------------------------------------------------

def _area_table(ssize: int, dsize: int) -> List[List[Tuple[int, float]]]:
    """Per output index, the (source index, float32 weight) list of OpenCV's
    computeResizeAreaTab (imgproc/src/resize.cpp), in its order."""
    scale = ssize / dsize
    tab: List[List[Tuple[int, float]]] = []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        row = []
        if sx1 - fsx1 > 1e-3:
            row.append((sx1 - 1, float(np.float32((sx1 - fsx1) / cell))))
        for sx in range(sx1, sx2):
            row.append((sx, float(np.float32(1.0 / cell))))
        if fsx2 - sx2 > 1e-3:
            row.append((sx2, float(np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell))))
        tab.append(row)
    return tab


def _area_weights(ssize: int, dsize: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The table as (index [dsize, L] int64, weight [dsize, L] f32), each row
    padded with weight-0 terms (adding 0 leaves a float sum unchanged)."""
    tab = _area_table(ssize, dsize)
    width = max(len(r) for r in tab)
    idx = torch.tensor([[r[k][0] if k < len(r) else 0 for k in range(width)] for r in tab])
    w = torch.tensor([[r[k][1] if k < len(r) else 0.0 for k in range(width)] for r in tab],
                     dtype=torch.float32)
    return idx.to(device), w.to(device)


def area_pool_uint8(tiles: torch.Tensor, size: int = 8) -> torch.Tensor:
    """uint8 [n, h, w, c] -> uint8 [n, size, size, c], equal bit for bit to
    ``cv2.resize(tile, (size, size), interpolation=cv2.INTER_AREA)``:

    - the same size: a copy;
    - integer factors (cv2's resizeAreaFast): each cell's integer sum; at 2 x
      2, ``(sum + 2) >> 2``; otherwise float32(sum) * float32(1 / area),
      rounded to nearest, ties to even (cvRound), saturated;
    - any other factor (cv2's resizeArea_): float32 terms in cv2's order, a
      source row's weighted columns summed left to right, then the rows'
      weighted sums top to bottom, each product and sum rounded to float32
      (two separate ops, no fused multiply-add), then cvRound.

    A tile edge below `size` (cv2's bilinear emulation) is not handled."""
    n, h, w, c = tiles.shape
    if h < size or w < size:
        raise ValueError(f"area pool: tile {h} x {w} is smaller than {size} x {size}")
    if h == size and w == size:
        return tiles.clone()
    if h % size == 0 and w % size == 0:
        ky, kx = h // size, w // size
        sums = tiles.reshape(n, size, ky, size, kx, c).to(torch.int32).sum((2, 4))
        if ky == 2 and kx == 2:
            return ((sums + 2) >> 2).to(torch.uint8)
        scale = torch.tensor(1.0 / (ky * kx), dtype=torch.float32, device=tiles.device)
        return torch.round(sums.to(torch.float32) * scale).clamp_(0, 255).to(torch.uint8)
    xi, xw = _area_weights(w, size, tiles.device)
    yi, yw = _area_weights(h, size, tiles.device)
    src = tiles.to(torch.float32)
    rows = torch.zeros(n, h, size, c, dtype=torch.float32, device=tiles.device)
    for k in range(xi.shape[1]):
        rows = rows + src[:, :, xi[:, k], :] * xw[:, k][None, None, :, None]
    out = torch.zeros(n, size, size, c, dtype=torch.float32, device=tiles.device)
    for k in range(yi.shape[1]):
        out = out + rows[:, yi[:, k], :, :] * yw[:, k][None, :, None, None]
    return torch.round(out).clamp_(0, 255).to(torch.uint8)


# ---------------------------------------------------------------------------
# numpy's float32 moments, on the device
# ---------------------------------------------------------------------------

def sequential_sum_f32(v: torch.Tensor) -> torch.Tensor:
    """float32 [C, P] of finite values >= 0 -> float32 [C]: each row summed
    left to right, every partial sum rounded to float32, as numpy reduces a
    non-contiguous axis (``flat.sum(1)`` of [n, P, 3]), bit for bit.

    The serial chain is replayed in parallel one float32 binade at a time:
    while the running sum S stays in [2^e, 2^(e+1)), it lives on the grid u
    = 2^(e-23), so each addend rounds to a whole number of u (round to
    nearest; a tie takes the even result, its parity read from a segmented
    prefix sum of the steps' parities, reset at each tie), and S is the
    prefix sum of those counts (int64, exact). The step that leaves the
    binade is taken on its own as a float32 add, and the next binade
    starts after it. Each pass reads a window of the columns from the
    earliest unfinished row's next addend, as wide as that offset (at least
    512): binades are crossed at offsets that grow geometrically. That
    offset is read back to the host each pass (about 40 passes at 256 px),
    so the call waits on the device that many times."""
    n_rows, P = v.shape
    dev = v.device
    S = v[:, 0].to(torch.float64)                              # a float32 value
    j0 = torch.ones(n_rows, dtype=torch.int64, device=dev)     # its next addend
    while True:
        lo = int(j0.min())
        if lo >= P:
            return S.to(torch.float32)
        hi = min(P, lo + max(512, lo))
        window = v[:, lo:hi]
        x = window.to(torch.float64)
        pos = torch.arange(lo, hi, device=dev)[None, :]
        rel = pos - lo
        _, ex = torch.frexp(S)    # S = m 2^ex, m in [0.5, 1); S = 0: any addend leaves
        e = torch.where(S > 0, ex - 1, torch.full_like(ex, -200))
        one = torch.ones_like(S)
        u = torch.ldexp(one, e - 23)[:, None]
        top = torch.ldexp(one, e + 1)[:, None]
        live = pos >= j0[:, None]
        q = torch.floor(x / u)
        r = x - q * u
        tie = live & (r == u / 2)
        # a count past 2^40 leaves the binade at once; the clamp keeps int64 sums exact
        q = torch.where(live, q.clamp(max=2.0 ** 40), 0.0).to(torch.int64)
        step = q + (live & (r > u / 2)).to(torch.int64)      # the steps without a tie
        par0 = (S[:, None] / u).to(torch.int64) & 1           # S / u < 2^24
        flips = torch.cumsum(torch.where(tie, 0, step & 1), 1)
        last_tie = torch.cummax(torch.where(tie, rel, -1), 1).values
        since = flips - torch.gather(flips, 1, last_tie.clamp(min=0))
        par_after = torch.where(last_tie >= 0, since, par0 + flips) & 1   # a tie ends even
        par_before = torch.cat([par0, par_after[:, :-1]], 1)
        step = torch.where(tie, q + ((par_before + q) & 1), step)
        s_after = S[:, None] + u * torch.cumsum(step, 1).to(torch.float64)
        s_before = torch.cat([S[:, None], s_after[:, :-1]], 1)
        leaves = live & (s_before + x >= top)
        first = torch.where(leaves, pos, hi).min(1).values
        k = (first.clamp(max=hi - 1) - lo)[:, None]
        taken = (torch.gather(s_before, 1, k).to(torch.float32)
                 + torch.gather(window, 1, k)).to(torch.float64)[:, 0]
        ahead = j0 < hi          # rows already past the window keep their state
        crossed = ahead & (first < hi)
        S = torch.where(crossed, taken, torch.where(ahead, s_after[:, -1], S))
        j0 = torch.where(crossed, first + 1, torch.where(ahead, torch.full_like(j0, hi), j0))


def numpy_moments(flat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 [n, P, c] -> (mean, std) [n, c], equal bit for bit to numpy's
    ``flat.mean(1)``, ``flat.std(1)``: sequential float32 sums, each divided
    by P in float64 and rounded to float32 (numpy's intp count), the
    deviations squared in float32, the square root correctly rounded."""
    n, P, c = flat.shape
    rows = flat.permute(0, 2, 1).reshape(n * c, P)
    mean = (sequential_sum_f32(rows).double() / P).to(torch.float32)
    dev = rows - mean[:, None]
    var = (sequential_sum_f32(dev * dev).double() / P).to(torch.float32)
    return mean.reshape(n, c), torch.sqrt(var.double()).to(torch.float32).reshape(n, c)


# ---------------------------------------------------------------------------
# Encoders
# ---------------------------------------------------------------------------

def _as_device_tiles(tiles, device) -> Tuple[torch.Tensor, bool]:
    """(uint8 tensor on `device`, whether the caller gave numpy)."""
    if isinstance(tiles, torch.Tensor):
        return tiles.to(device), False
    return torch.from_numpy(np.ascontiguousarray(tiles, np.uint8)).to(device), True


class HandcraftedEncoder:
    """Deterministic classical descriptor (no weights), the JAX package's:
    8x8x3 area-pooled RGB + per-channel mean and std (ddof 0) in float32,
    each equal bit for bit to the JAX package's numpy values
    (`area_pool_uint8`, `numpy_moments`), projected to `dim` by a fixed
    random projection drawn on the host (``np.random.default_rng(seed)``,
    as JAX draws it) and L2-normalised (+1e-8). The projection and the
    normalisation run in float64, as numpy promotes them. Runs on `device`
    (default CUDA)."""

    def __init__(self, dim: int = 512, seed: int = 0, device=None):
        self.dim = dim
        self._seed = seed
        self.device = resolve_device(device)
        self._proj: Optional[torch.Tensor] = None

    def _projection(self, n_desc: int) -> torch.Tensor:
        if self._proj is None or self._proj.shape[0] != n_desc:
            rng = np.random.default_rng(self._seed)
            draw = rng.standard_normal((n_desc, self.dim)).astype(np.float32)
            proj = draw.astype(np.float64) / np.sqrt(n_desc)   # numpy 2's promotion
            self._proj = torch.from_numpy(proj).to(self.device)
        return self._proj

    @torch.no_grad()
    def __call__(self, tiles):
        x, host = _as_device_tiles(tiles, self.device)
        n = x.shape[0]
        pooled = area_pool_uint8(x, 8).reshape(n, -1).to(torch.float32) / 255.0
        mean, std = numpy_moments(x.reshape(n, -1, 3).to(torch.float32) / 255.0)
        desc = torch.cat([pooled, mean, std], 1)
        out = desc.double() @ self._projection(desc.shape[1])
        out = (out / (torch.linalg.vector_norm(out, dim=1, keepdim=True) + 1e-8)).float()
        return out.cpu().numpy() if host else out


class TorchPatchEncoder:
    """Wrap an ``nn.Module`` or a function on tensors (JAX: JaxPatchEncoder):
    tiles go to `device` (default CUDA), become float32 / 255 there, then
    pass the optional `preprocess`, then the optional `dtype` cast (a
    module's parameters are cast to it too), and are encoded in one call
    per batch. Returns float32 features."""

    def __init__(self, fn, preprocess=None, dtype: Optional[torch.dtype] = None, device=None):
        self.device = resolve_device(device)
        if isinstance(fn, nn.Module):
            fn = (fn.to(self.device) if dtype is None else fn.to(self.device, dtype)).eval()
        self.fn = fn
        self.preprocess = preprocess
        self.dtype = dtype

    @torch.no_grad()
    def __call__(self, tiles):
        x, host = _as_device_tiles(tiles, self.device)
        x = x.to(torch.float32) / 255.0
        if self.preprocess is not None:
            x = self.preprocess(x)
        if self.dtype is not None:
            x = x.to(self.dtype)
        out = self.fn(x).to(torch.float32)
        return out.cpu().numpy() if host else out


def make_conch_encoder(checkpoint: str = "conch_ViT-B-16",
                       hf_repo: str = "hf_hub:MahmoodLab/conch",
                       img_size: int = 224, device=None) -> TileEncoder:
    """CONCH patch encoder (ref: conch_patch_embedder.py:75-95,122-125):
    ``encode_image(proj_contrast=False, normalize=False)`` -> 512-d, the
    model on `device` (default CUDA). Requires the external `conch` package
    and the gated MahmoodLab/conch weights."""
    try:
        from conch.open_clip_custom import create_model_from_pretrained
    except ImportError as e:
        raise ImportError(
            "CONCH unavailable: install the `conch` package and request access "
            "to MahmoodLab/conch weights, or pass a custom encoder.") from e

    dev = resolve_device(device)
    model, preprocess = create_model_from_pretrained(
        checkpoint, hf_repo, force_image_size=img_size)
    model.eval().to(dev)

    def encode(tiles):
        from PIL import Image

        host = not isinstance(tiles, torch.Tensor)
        arr = tiles if host else tiles.cpu().numpy()
        with torch.inference_mode():
            batch = torch.stack([preprocess(Image.fromarray(t)) for t in arr]).to(dev)
            feats = model.encode_image(batch, proj_contrast=False, normalize=False).float()
        return feats.cpu().numpy() if host else feats

    encode.dim = 512
    return encode


# ---------------------------------------------------------------------------
# Embedder
# ---------------------------------------------------------------------------

class _PartClock:
    """Seconds by part: CUDA-event pairs on the card, read once at the end
    (no sync in between); the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.seconds: Dict[str, float] = defaultdict(float)
        self._pairs: Dict[str, list] = defaultdict(list)

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def add(self, part: str, start, end) -> None:
        if self.cuda:
            self._pairs[part].append((start, end))
        else:
            self.seconds[part] += end - start

    def totals(self) -> Dict[str, float]:
        for part, pairs in self._pairs.items():
            if pairs:
                pairs[-1][1].synchronize()
            self.seconds[part] += sum(a.elapsed_time(b) for a, b in pairs) / 1e3
        self._pairs.clear()
        return dict(self.seconds)


class TileEmbedder:
    """Patch a slide and write its tile features as one bag
    (surface parity: ref TileEmbedder.embed_tiles, conch_patch_embedder.py:97-134).

    The tiles are read at the read level, copied to `device` (default CUDA)
    and resized and encoded there; `encoder` defaults to a
    HandcraftedEncoder on that device. `bag_format` is h5 (the JAX
    package's; needs h5py, checked here), npz or bag. `timings` holds the
    last slide's seconds by part: plan, read (host regions into the pinned
    buffer), h2d, resize, encode (device time, CUDA events), write (host),
    and its wall time and tile count."""

    def __init__(
        self,
        encoder: Optional[TileEncoder] = None,
        target_patch_size: int = 256,
        target_mag: float = 10.0,
        batch_size: int = 64,
        save_path: str = ".",
        device=None,
        bag_format: str = "h5",
    ):
        if bag_format not in BAG_FORMATS:
            raise ValueError(f"bag_format {bag_format!r}: one of {BAG_FORMATS}")
        if bag_format == "h5":
            bag_io.need_h5py(f"{save_path}/patch_embeddings/*.h5")
        self.device = resolve_device(device)
        self.encoder = encoder or HandcraftedEncoder(device=self.device)
        self.target_patch_size = target_patch_size
        self.target_mag = target_mag
        self.batch_size = batch_size
        self.save_path = save_path
        self.bag_format = bag_format
        self.timings: Dict[str, float] = {}

    def embed_tiles(self, wsi, mask: Optional[np.ndarray], fn: str,
                    pixel_size: Optional[float] = None) -> str:
        """Segmented slide -> ``<save_path>/patch_embeddings/<fn>.<bag_format>``."""
        t_start = time.perf_counter()
        wsi = wsi_factory(wsi, pixel_size)
        px = pixel_size or getattr(wsi, "pixel_size", None)
        if px is None:
            raise ValueError("pixel_size required")
        patcher = WSIPatcher(
            wsi, self.target_patch_size, px,
            dst_pixel_size=mag_to_px_size(self.target_mag), mask=mask)
        clock = _PartClock(self.device)
        clock.seconds["plan"] = time.perf_counter() - t_start

        out_dir = os.path.join(self.save_path, "patch_embeddings")
        os.makedirs(out_dir, exist_ok=True)
        out_path = os.path.join(out_dir, f"{fn}.{self.bag_format}")
        if os.path.exists(out_path):
            os.remove(out_path)

        coords = patcher.coords
        pin = self.device.type == "cuda"
        feats: List[np.ndarray] = []
        pending = None
        for start in range(0, len(patcher), self.batch_size):
            idx = range(start, min(start + self.batch_size, len(patcher)))
            t0 = time.perf_counter()
            regions = patcher.read_regions(idx, pin=pin)
            clock.seconds["read"] += time.perf_counter() - t0
            m0 = clock.mark()
            dev = regions.to(self.device, non_blocking=True)
            m1 = clock.mark()
            tiles = patcher.resize(dev)
            m2 = clock.mark()
            out = torch.as_tensor(self.encoder(tiles), dtype=torch.float32)
            m3 = clock.mark()
            for part, a, b in (("h2d", m0, m1), ("resize", m1, m2), ("encode", m2, m3)):
                clock.add(part, a, b)
            host = torch.empty(out.shape, dtype=torch.float32, pin_memory=pin)
            host.copy_(out, non_blocking=True)
            done = clock.mark() if pin else None
            if pending is not None:
                self._write(out_path, feats, *pending, clock)
            pending = (host, done, coords[idx.start:idx.stop])
        if pending is not None:
            self._write(out_path, feats, *pending, clock)

        t0 = time.perf_counter()
        if self.bag_format != "h5" or not os.path.exists(out_path):
            dim = getattr(self.encoder, "dim", 512)
            rows = np.concatenate(feats) if feats else np.zeros((0, dim), np.float32)
            write = bag_io.append_bag if self.bag_format == "h5" else bag_io.write_bag
            write(out_path, rows, coords)   # no tissue tile: an empty but valid bag
        clock.seconds["write"] += time.perf_counter() - t0
        self.timings = dict(clock.totals(), wall=time.perf_counter() - t_start,
                            tiles=len(patcher))
        return out_path

    def _write(self, out_path: str, feats: List[np.ndarray], host: torch.Tensor, done,
               coords: np.ndarray, clock: _PartClock) -> None:
        """A batch's features once its copy has landed: appended to the
        ``.h5`` file, or kept for the one write of ``.npz`` / ``.bag``."""
        if done is not None:
            done.synchronize()
        t0 = time.perf_counter()
        rows = host.numpy().copy()
        if self.bag_format == "h5":
            bag_io.append_bag(out_path, rows, coords)
        else:
            feats.append(rows)
        clock.seconds["write"] += time.perf_counter() - t0
