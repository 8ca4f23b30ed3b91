"""Grid patching with rescale + tissue-mask intersection (JAX:
madeleine_tpu/preprocessing/patching.py; ref: preprocessing/hest_modules/wsi.py:234-487).

`WSIPatcher` lays a grid of fixed-size tiles over a slide at a target pixel
size (or magnification), reads each at the best pyramid level, and keeps the
tiles that meet the tissue mask. Its plan (grid, tissue test, row-major
order) is the JAX package's, so ``coords`` equal its coords bit for bit.

Where a region must be resized to ``patch_size``, the resize is
`preprocessing.vit.resize_uint8` (half-pixel bilinear, rounded back to
uint8): within one level of the JAX package's cv2.INTER_LINEAR. `get_tile`
does it on the host and returns a numpy tile, the JAX surface; the tile
embedder reads whole batches instead (`read_regions`, one pinned host
buffer), copies each to the card in one copy and resizes it there (`resize`).
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from madeleine_torch.preprocessing.vit import resize_uint8
from madeleine_torch.preprocessing.wsi import WSI, wsi_factory


def mag_to_px_size(mag: float) -> float:
    """Objective magnification -> approximate um/px
    (ref: conch_patch_embedder.py:152-158)."""
    table = {40.0: 0.25, 20.0: 0.5, 10.0: 1.0, 5.0: 2.0}
    if float(mag) in table:
        return table[float(mag)]
    return 10.0 / float(mag)


class WSIPatcher:
    """Iterate (tile_rgb, x, y) over the tissue grid.

    Args:
      wsi: slide (or anything wsi_factory accepts).
      patch_size: output tile edge in pixels (dst space).
      src_pixel_size: slide MPP; dst_pixel_size: target MPP.
      mask: optional binary tissue mask (any resolution; scaled to the slide).
      overlap: tile overlap in dst pixels.
      min_tissue_frac: keep a tile if >= this fraction of its area is tissue;
        corner_mode keeps it if any corner is tissue (ref wsi.py:313-351).
    """

    def __init__(
        self,
        wsi,
        patch_size: int,
        src_pixel_size: float,
        dst_pixel_size: Optional[float] = None,
        mag: Optional[float] = None,
        mask: Optional[np.ndarray] = None,
        overlap: int = 0,
        min_tissue_frac: float = 0.1,
        corner_mode: bool = False,
    ):
        self.wsi: WSI = wsi_factory(wsi, src_pixel_size)
        self.patch_size = patch_size
        self.src_pixel_size = src_pixel_size
        if dst_pixel_size is None:
            dst_pixel_size = mag_to_px_size(mag) if mag else src_pixel_size
        self.dst_pixel_size = dst_pixel_size
        self.downsample = dst_pixel_size / src_pixel_size
        self.src_patch_size = int(round(patch_size * self.downsample))
        self.step = int(round((patch_size - overlap) * self.downsample))
        self.mask = mask
        self.min_tissue_frac = min_tissue_frac
        self.corner_mode = corner_mode

        # best pyramid level: largest downsample <= needed (ref: wsi.py:471-480)
        self.level = self.wsi.best_level_for_downsample(self.downsample)
        self.level_downsample = self.wsi.level_downsamples[self.level]
        self.level_patch_size = int(round(self.src_patch_size /
                                          self.level_downsample))

        w, h = self.wsi.dimensions
        self.cols = max(1, (w - self.src_patch_size) // self.step + 1) if w >= self.src_patch_size else 0
        self.rows = max(1, (h - self.src_patch_size) // self.step + 1) if h >= self.src_patch_size else 0
        self._coords = self._plan()

    # ------------------------------------------------------------------
    def _tissue_ok(self, x: int, y: int) -> bool:
        if self.mask is None:
            return True
        mh, mw = self.mask.shape[:2]
        w, h = self.wsi.dimensions
        sx, sy = mw / w, mh / h
        x0 = int(x * sx); y0 = int(y * sy)
        x1 = max(x0 + 1, int((x + self.src_patch_size) * sx))
        y1 = max(y0 + 1, int((y + self.src_patch_size) * sy))
        x1 = min(x1, mw); y1 = min(y1, mh)
        if x0 >= mw or y0 >= mh:
            return False
        if self.corner_mode:
            # exact reference semantics: any corner inside tissue (wsi.py:313-351)
            corners = [(x0, y0), (x1 - 1, y0), (x0, y1 - 1), (x1 - 1, y1 - 1)]
            return any(bool(self.mask[cy, cx]) for cx, cy in corners)
        region = self.mask[y0:y1, x0:x1]
        return region.size > 0 and region.mean() >= self.min_tissue_frac

    def _plan(self) -> List[Tuple[int, int]]:
        coords = []
        for r in range(self.rows):
            for c in range(self.cols):
                x, y = c * self.step, r * self.step
                if self._tissue_ok(x, y):
                    coords.append((x, y))
        return coords

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._coords)

    @property
    def coords(self) -> np.ndarray:
        """Level-0 (x, y) of kept tiles, the bag's ``coords`` payload."""
        return np.asarray(self._coords, np.int64).reshape(-1, 2)

    def _read(self, index: int) -> np.ndarray:
        x, y = self._coords[index]   # read_region takes level-0 coords
        return self.wsi.read_region((x, y), self.level,
                                    (self.level_patch_size, self.level_patch_size))

    def get_tile(self, index: int) -> Tuple[np.ndarray, int, int]:
        """(RGB uint8 tile [patch_size, patch_size, 3], x, y); the resize,
        where needed, on the host."""
        tile = self._read(index)
        if tile.shape[0] != self.patch_size:
            tile = resize_uint8(torch.from_numpy(tile)[None], self.patch_size)[0].numpy()
        x, y = self._coords[index]
        return tile, x, y

    def __getitem__(self, index: int):
        return self.get_tile(index)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, int, int]]:
        for i in range(len(self)):
            yield self.get_tile(i)

    def read_regions(self, indices: Sequence[int], pin: bool = False) -> torch.Tensor:
        """The regions of plan entries `indices` at the read level, uint8 [n,
        level_patch_size, level_patch_size, 3] in one host tensor (pinned for
        an asynchronous copy when `pin`)."""
        s = self.level_patch_size
        out = torch.empty((len(indices), s, s, 3), dtype=torch.uint8, pin_memory=pin)
        view = out.numpy()
        for j, i in enumerate(indices):
            view[j] = self._read(i)
        return out

    def resize(self, regions: torch.Tensor) -> torch.Tensor:
        """Regions at the read level (on any device) -> tiles of patch_size,
        where they differ."""
        if regions.shape[1] == self.patch_size:
            return regions
        return resize_uint8(regions, self.patch_size)

    def visualize_grid(self, out_path: str, thumb_width: int = 1000) -> None:
        """Save a patch-grid overlay thumbnail (ref: wsi.py:429-457)."""
        import cv2

        w, h = self.wsi.dimensions
        scale = thumb_width / w
        thumb = self.wsi.get_thumbnail(thumb_width, int(h * scale)).copy()
        ps = max(1, int(self.src_patch_size * scale))
        for x, y in self._coords:
            cv2.rectangle(thumb, (int(x * scale), int(y * scale)),
                          (int(x * scale) + ps, int(y * scale) + ps),
                          (0, 255, 0), 1)
        cv2.imwrite(out_path, cv2.cvtColor(thumb, cv2.COLOR_RGB2BGR))
