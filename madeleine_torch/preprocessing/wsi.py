"""Whole-slide image readers (JAX: madeleine_tpu/preprocessing/wsi.py; ref:
preprocessing/hest_modules/wsi.py:39-231).

The same family with the same surface: `NumpyWSI` (an in-memory array),
`PILWSI` (a plain image file) and `OpenSlideWSI` (pyramidal formats, gated on
the openslide package, which the card's machine lacks); `wsi_factory`
dispatches as ref wsi.py:84-106 does. Pixel size (MPP) comes from the
reader's own value, then openslide's properties, then a given default
(ref wsi.py:562-584).

Readers return RGB uint8 numpy arrays: slide I/O is host work. cv2 and PIL
are imported only inside the functions that use them, where the JAX
package imports them, so importing this module loads neither; openslide is
only looked up (`HAVE_OPENSLIDE`) until a slide needs it.
"""

from __future__ import annotations

import importlib.util
from typing import Optional, Tuple, Union

import numpy as np

HAVE_OPENSLIDE = importlib.util.find_spec("openslide") is not None
OPENSLIDE_EXTENSIONS = (".svs", ".mrxs", ".ndpi", ".tiff", ".tif")


class WSI:
    """Abstract slide: level-0 dimensions + region reads at arbitrary levels."""

    def __init__(self, img):
        self.img = img

    @property
    def dimensions(self) -> Tuple[int, int]:  # (width, height) at level 0
        raise NotImplementedError

    @property
    def level_count(self) -> int:
        return 1

    @property
    def level_downsamples(self) -> Tuple[float, ...]:
        return (1.0,)

    @property
    def level_dimensions(self) -> Tuple[Tuple[int, int], ...]:
        return (self.dimensions,)

    def read_region(self, location: Tuple[int, int], level: int,
                    size: Tuple[int, int]) -> np.ndarray:
        """RGB uint8 [h, w, 3]; location in level-0 coords, size in level coords."""
        raise NotImplementedError

    def get_thumbnail(self, width: int, height: int) -> np.ndarray:
        raise NotImplementedError

    def best_level_for_downsample(self, downsample: float) -> int:
        """Largest level whose downsample <= requested (ref: wsi.py:471-480)."""
        best = 0
        for i, ds in enumerate(self.level_downsamples):
            if ds <= downsample + 1e-3:
                best = i
        return best


class NumpyWSI(WSI):
    """In-memory single-level slide (ref: wsi.py NumpyWSI)."""

    def __init__(self, img: np.ndarray, pixel_size: Optional[float] = None):
        super().__init__(np.asarray(img))
        self.pixel_size = pixel_size

    @property
    def dimensions(self) -> Tuple[int, int]:
        h, w = self.img.shape[:2]
        return (w, h)

    def read_region(self, location, level, size) -> np.ndarray:
        """Zero-filled where the region leaves the slide."""
        assert level == 0
        x, y = location
        w, h = size
        H, W = self.img.shape[:2]
        out = np.zeros((h, w, 3), np.uint8)
        x0, y0 = max(x, 0), max(y, 0)
        x1, y1 = min(x + w, W), min(y + h, H)
        if x1 > x0 and y1 > y0:
            out[y0 - y:y1 - y, x0 - x:x1 - x] = self.img[y0:y1, x0:x1, :3]
        return out

    def get_thumbnail(self, width: int, height: int) -> np.ndarray:
        import cv2

        return cv2.resize(self.img[:, :, :3], (width, height),
                          interpolation=cv2.INTER_AREA)


class PILWSI(WSI):
    """Plain image file via PIL (single level); the decoded image and, at the
    first region read, its numpy view stay in host memory."""

    def __init__(self, path: str, pixel_size: Optional[float] = None):
        from PIL import Image

        Image.MAX_IMAGE_PIXELS = None
        img = Image.open(path).convert("RGB")
        super().__init__(img)
        self._np: Optional[np.ndarray] = None
        self.pixel_size = pixel_size or _pil_pixel_size(img)

    def _array(self) -> np.ndarray:
        if self._np is None:
            self._np = np.asarray(self.img)
        return self._np

    @property
    def dimensions(self) -> Tuple[int, int]:
        return self.img.size  # PIL: (width, height)

    def read_region(self, location, level, size) -> np.ndarray:
        assert level == 0
        return NumpyWSI(self._array()).read_region(location, level, size)

    def get_thumbnail(self, width: int, height: int) -> np.ndarray:
        thumb = self.img.resize((width, height))
        return np.asarray(thumb)


class OpenSlideWSI(WSI):
    """Pyramidal slide via openslide (ref: wsi.py:140-231). Gated."""

    def __init__(self, img, pixel_size: Optional[float] = None):
        if not HAVE_OPENSLIDE:
            raise ImportError(
                "openslide is not available in this environment; use PILWSI or "
                "NumpyWSI, or install openslide-python + libopenslide.")
        super().__init__(img)
        self.pixel_size = pixel_size

    @property
    def dimensions(self):
        return self.img.dimensions

    @property
    def level_count(self) -> int:
        return self.img.level_count

    @property
    def level_downsamples(self):
        return tuple(self.img.level_downsamples)

    @property
    def level_dimensions(self):
        return tuple(self.img.level_dimensions)

    def read_region(self, location, level, size) -> np.ndarray:
        region = self.img.read_region(location, level, size).convert("RGB")
        return np.asarray(region)

    def get_thumbnail(self, width: int, height: int) -> np.ndarray:
        return np.asarray(self.img.get_thumbnail((width, height)).convert("RGB"))


def wsi_factory(src: Union[str, np.ndarray, WSI],
                pixel_size: Optional[float] = None) -> WSI:
    """Dispatch on source type (ref: wsi.py:84-106): a pyramidal file goes to
    openslide where it imports, any other path to PIL."""
    if isinstance(src, WSI):
        return src
    if isinstance(src, np.ndarray):
        return NumpyWSI(src, pixel_size)
    if isinstance(src, str):
        if HAVE_OPENSLIDE and src.lower().endswith(OPENSLIDE_EXTENSIONS):
            import openslide

            return OpenSlideWSI(openslide.OpenSlide(src), pixel_size)
        return PILWSI(src, pixel_size)
    raise TypeError(f"cannot open WSI from {type(src)}")


def _pil_pixel_size(img) -> Optional[float]:
    """MPP from TIFF resolution tags when present (ref: wsi.py:571-580)."""
    try:
        info = getattr(img, "info", {})
        res = info.get("resolution") or info.get("dpi")
        if res and res[0]:
            unit = info.get("resolution_unit", 2)
            per_unit = float(res[0])
            if per_unit <= 0:
                return None
            microns = 25400.0 if unit == 2 else 10000.0  # inch vs cm
            return microns / per_unit
    except Exception:
        pass
    return None


def get_pixel_size(wsi: WSI, default: Optional[float] = None) -> float:
    """MPP (um/px) of level 0 (ref: wsi.py:562-584)."""
    ps = getattr(wsi, "pixel_size", None)
    if ps:
        return float(ps)
    if HAVE_OPENSLIDE and hasattr(wsi, "img") and hasattr(wsi.img, "properties"):
        props = wsi.img.properties
        mppx = props.get("openslide.mpp-x")
        if mppx:
            return float(mppx)
        res_unit = props.get("tiff.ResolutionUnit")
        xres = props.get("tiff.XResolution")
        if xres:
            factor = 25400.0 if res_unit == "inch" else 10000.0
            return factor / float(xres)
    if default is not None:
        return float(default)
    raise ValueError("could not infer pixel size; pass pixel_size explicitly")
