"""Tissue segmentation (JAX: madeleine_tpu/preprocessing/segmentation.py;
ref: preprocessing/hest_modules/segmentation.py:42-374).

Two backends behind one surface, as in the JAX package:

- ``otsu`` (default): HSV-saturation Otsu threshold on a thumbnail of at most
  4000 x 4000 plus morphology, the CLAM-style pipeline the MADELEINE
  walkthrough uses for BCNB;
- ``model``: any callable ``tiles_uint8 [n, 512, 512, 3] -> prob/mask [n, 512,
  512]``, run on 512-px tiles at 1 um/px and stitched as the reference does
  (segmentation.py:113-135); `make_torch_deeplab_fn` wraps the reference's
  DeepLabV3-ResNet50 (torchvision) as one.

The mask, the contour walk and the artifacts are host work with cv2 and
numpy, the JAX package's own code, so the mask and the contours equal its
bit for bit. cv2 is imported inside the functions that use it.
`TissueSegmenter.timings` holds the seconds of the last call by part.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from madeleine_torch.preprocessing.wsi import WSI, wsi_factory

TARGET_SEG_PIXEL_SIZE = 1.0  # um/px for segmentation (ref: segmentation.py:107)
SEG_TILE = 512               # tile edge (ref: segmentation.py:107)


# ---------------------------------------------------------------------------
# Contours
# ---------------------------------------------------------------------------

def filter_contours(
    contours: List[np.ndarray],
    hierarchy: np.ndarray,
    min_area: float,
    max_hole_area: float = float("inf"),
) -> Tuple[List[np.ndarray], List[List[np.ndarray]]]:
    """Area-filter outer contours and their holes
    (ref: segmentation.py filter_contours)."""
    import cv2

    if hierarchy is None or len(contours) == 0:
        return [], []
    hierarchy = hierarchy.reshape(-1, 4)
    keep, holes = [], []
    for idx, cont in enumerate(contours):
        if hierarchy[idx][3] != -1:  # not a top-level contour
            continue
        area = cv2.contourArea(cont)
        # subtract hole areas like the reference's foreground area test
        child_idx = [i for i in range(len(contours)) if hierarchy[i][3] == idx]
        hole_area = sum(cv2.contourArea(contours[i]) for i in child_idx)
        if area - hole_area < min_area:
            continue
        keep.append(cont.reshape(-1, 2))
        kept_holes = [contours[i].reshape(-1, 2) for i in child_idx
                      if cv2.contourArea(contours[i]) <= max_hole_area]
        holes.append(kept_holes)
    return keep, holes


def mask_to_contours(
    mask: np.ndarray,
    pixel_size: float = 1.0,
    min_area_um2: float = 50_000.0,
    max_dim: int = 2000,
) -> Tuple[List[np.ndarray], List[List[np.ndarray]], float]:
    """Binary mask -> (contours, holes, scale) in mask coordinates scaled by
    `scale` (ref: mask_to_gdf, segmentation.py:324-374)."""
    import cv2

    h, w = mask.shape[:2]
    scale = min(1.0, max_dim / max(h, w))
    if scale < 1.0:
        small = cv2.resize(mask.astype(np.uint8), (int(w * scale), int(h * scale)),
                           interpolation=cv2.INTER_NEAREST)
    else:
        small = mask.astype(np.uint8)
    contours, hierarchy = cv2.findContours(small, cv2.RETR_CCOMP,
                                           cv2.CHAIN_APPROX_SIMPLE)
    eff_px = pixel_size / scale
    min_area_px = min_area_um2 / (eff_px * eff_px)
    keep, holes = filter_contours(list(contours), hierarchy, min_area_px)
    inv = 1.0 / scale
    keep = [np.asarray(c, np.float64) * inv for c in keep]
    holes = [[np.asarray(hc, np.float64) * inv for hc in hs] for hs in holes]
    return keep, holes, scale


def contours_to_mask(shape: Tuple[int, int], contours: List[np.ndarray],
                     holes: Optional[List[List[np.ndarray]]] = None) -> np.ndarray:
    import cv2

    mask = np.zeros(shape, np.uint8)
    if contours:
        cv2.fillPoly(mask, [c.astype(np.int32) for c in contours], 1)
    if holes:
        flat = [h.astype(np.int32) for hs in holes for h in hs]
        if flat:
            cv2.fillPoly(mask, flat, 0)
    return mask


def contours_to_geojson(contours: List[np.ndarray],
                        holes: Optional[List[List[np.ndarray]]] = None,
                        scale: float = 1.0) -> dict:
    """Contours (+holes) -> a GeoJSON FeatureCollection dict matching the
    reference's geopandas export: one Polygon Feature per tissue contour with
    a ``tissue_id`` property, hole rings as interior rings
    (ref: segmentation.py:142-147 gdf.to_file(..., driver="GeoJSON") of
    mask_to_gdf's GeoDataFrame, segmentation.py:324-374). Plain json — no
    geopandas/shapely needed. `scale` maps mask coords -> slide coords."""

    def ring(points: np.ndarray) -> List[List[float]]:
        pts = np.asarray(points, np.float64) * scale
        closed = pts.tolist()
        if closed and closed[0] != closed[-1]:   # GeoJSON rings are closed
            closed.append(closed[0])
        return closed

    features = []
    for i, cont in enumerate(contours):
        rings = [ring(cont)]
        if holes and i < len(holes):
            rings.extend(ring(hc) for hc in holes[i])
        features.append({
            "type": "Feature",
            "properties": {"tissue_id": i},
            "geometry": {"type": "Polygon", "coordinates": rings},
        })
    return {"type": "FeatureCollection", "features": features}


def make_torch_deeplab_fn(checkpoint_path: Optional[str] = None,
                          device=None) -> Callable:
    """Adapter: the reference's DeepLabV3-ResNet50 tissue model as a
    TissueSegmenter ``model_fn`` on `device` (default CUDA) (ref:
    segmentation.py:56-67 loads torchvision's deeplabv3_resnet50 with the
    HF-hosted MahmoodLab/hest-tissue-seg weights). Needs torchvision and a
    local checkpoint; the Otsu backend needs neither."""
    try:
        import torch
        from torchvision.models.segmentation import deeplabv3_resnet50
    except ImportError as e:
        raise ImportError(
            "torchvision is required for the DeepLab segmentation backend; "
            "use backend='otsu' or pass a custom model_fn.") from e
    from madeleine_torch.utils.device import resolve_device

    dev = resolve_device(device)
    model = deeplabv3_resnet50(num_classes=2)
    if checkpoint_path:
        sd = torch.load(checkpoint_path, map_location="cpu", weights_only=False)
        sd = sd.get("state_dict", sd)
        sd = {k.replace("model.", "", 1): v for k, v in sd.items()}
        model.load_state_dict(sd, strict=False)
    model.eval().to(dev)
    mean = torch.tensor([0.485, 0.456, 0.406], device=dev)
    std = torch.tensor([0.229, 0.224, 0.225], device=dev)

    def model_fn(tiles: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(tiles)).to(dev).float() / 255.0
            x = ((x - mean) / std).permute(0, 3, 1, 2)
            out = model(x)["out"]                         # [n, 2, H, W]
            return out.argmax(1).float().cpu().numpy()    # tissue = class 1

    return model_fn


# ---------------------------------------------------------------------------
# Segmenter
# ---------------------------------------------------------------------------

class TissueSegmenter:
    """Tissue segmentation with pluggable backend
    (surface parity with ref TissueSegmenter.segment_tissue, segmentation.py:90)."""

    def __init__(
        self,
        save_path: Optional[str] = None,
        batch_size: int = 64,
        backend: str = "otsu",
        model_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        min_area_um2: float = 50_000.0,
        sat_thresh: Optional[int] = None,
    ):
        self.save_path = save_path
        self.batch_size = batch_size
        self.backend = backend
        self.model_fn = model_fn
        self.min_area_um2 = min_area_um2
        self.sat_thresh = sat_thresh
        self.timings: Dict[str, float] = {}
        if backend == "model" and model_fn is None:
            raise ValueError("backend='model' requires model_fn")

    # -- otsu backend ---------------------------------------------------
    def _segment_otsu(self, wsi: WSI, pixel_size: float) -> np.ndarray:
        import cv2

        t0 = time.perf_counter()
        w, h = wsi.dimensions
        # thumbnail at ~segmentation resolution, capped for memory
        ds = max(1.0, TARGET_SEG_PIXEL_SIZE * 8 / pixel_size)
        tw, th = max(1, int(w / ds)), max(1, int(h / ds))
        tw, th = min(tw, 4000), min(th, 4000)
        thumb = wsi.get_thumbnail(tw, th)
        self.timings["thumbnail"] = time.perf_counter() - t0
        hsv = cv2.cvtColor(thumb, cv2.COLOR_RGB2HSV)
        sat = cv2.medianBlur(hsv[:, :, 1], 7)
        if self.sat_thresh is not None:
            _, mask = cv2.threshold(sat, self.sat_thresh, 1, cv2.THRESH_BINARY)
        else:
            _, mask = cv2.threshold(sat, 0, 1,
                                    cv2.THRESH_BINARY + cv2.THRESH_OTSU)
        kernel = np.ones((5, 5), np.uint8)
        mask = cv2.morphologyEx(mask, cv2.MORPH_CLOSE, kernel)
        mask = cv2.morphologyEx(mask, cv2.MORPH_OPEN, kernel)
        return mask.astype(np.uint8)

    # -- tiled model backend --------------------------------------------
    def _segment_model(self, wsi: WSI, pixel_size: float) -> np.ndarray:
        """Tile at 1 um/px / 512 px, run model_fn in batches, stitch argmax
        (ref: segmentation.py:110-135)."""
        from madeleine_torch.preprocessing.patching import WSIPatcher

        patcher = WSIPatcher(wsi, SEG_TILE, pixel_size,
                             dst_pixel_size=TARGET_SEG_PIXEL_SIZE,
                             min_tissue_frac=0.0)
        w, h = wsi.dimensions
        scale = pixel_size / TARGET_SEG_PIXEL_SIZE
        mw, mh = int(w * scale) + 1, int(h * scale) + 1
        mask = np.zeros((mh, mw), np.uint8)
        tiles, locs = [], []

        def flush():
            if not tiles:
                return
            out = self.model_fn(np.stack(tiles))
            for m, (x, y) in zip(out, locs):
                xm, ym = int(x * scale), int(y * scale)
                mm = (m > 0.5).astype(np.uint8)
                hgt = min(SEG_TILE, mh - ym)
                wid = min(SEG_TILE, mw - xm)
                mask[ym:ym + hgt, xm:xm + wid] = mm[:hgt, :wid]
            tiles.clear(); locs.clear()

        for tile, x, y in patcher:
            tiles.append(tile); locs.append((x, y))
            if len(tiles) >= self.batch_size:
                flush()
        flush()
        return mask

    # -- public surface -------------------------------------------------
    def segment_tissue(self, wsi, pixel_size: float,
                       save_bn: Optional[str] = None):
        """Returns (mask, contours, holes); saves jpeg + pkl + GeoJSON
        artifacts like the reference (segmentation.py:140-150) when
        save_path/save_bn given. `timings`: the backend's pass ("thumbnail"
        and "otsu_contours", or "model_contours"), "save"."""
        self.timings = {}
        wsi = wsi_factory(wsi, pixel_size)
        t0 = time.perf_counter()
        if self.backend == "otsu":
            mask = self._segment_otsu(wsi, pixel_size)
            w, h = wsi.dimensions
            mask_px = pixel_size * (w / mask.shape[1])
            part = "otsu_contours"
        else:
            mask = self._segment_model(wsi, pixel_size)
            mask_px = TARGET_SEG_PIXEL_SIZE
            part = "model_contours"
        contours, holes, _ = mask_to_contours(mask, mask_px,
                                              min_area_um2=self.min_area_um2)
        # keep only polygon area as tissue
        mask = contours_to_mask(mask.shape[:2], contours, holes)
        self.timings[part] = (time.perf_counter() - t0 - self.timings.get("thumbnail", 0.0))

        t0 = time.perf_counter()
        if self.save_path and save_bn:
            os.makedirs(self.save_path, exist_ok=True)
            self._save_artifacts(wsi, mask, contours, holes, save_bn)
        self.timings["save"] = time.perf_counter() - t0
        return mask, contours, holes

    def _save_artifacts(self, wsi, mask, contours, holes, save_bn: str) -> None:
        import json

        import cv2

        vis_dir = os.path.join(self.save_path, "segmentation_vis")
        pkl_dir = os.path.join(self.save_path, "segmentation_pkl")
        geo_dir = os.path.join(self.save_path, "geojson")
        os.makedirs(vis_dir, exist_ok=True)
        os.makedirs(pkl_dir, exist_ok=True)
        os.makedirs(geo_dir, exist_ok=True)
        # GeoJSON contour export in slide (level-0) coordinates — the
        # published artifact downstream tools consume (ref: segmentation.py:146)
        geo_scale = wsi.dimensions[0] / mask.shape[1]
        with open(os.path.join(geo_dir, f"{save_bn}_tissue_mask.geojson"),
                  "w") as f:
            json.dump(contours_to_geojson(contours, holes, scale=geo_scale), f)
        w, h = wsi.dimensions
        tw = 1000
        thumb = wsi.get_thumbnail(tw, int(h * tw / w)).copy()
        sx = thumb.shape[1] / mask.shape[1]
        sy = thumb.shape[0] / mask.shape[0]
        cv2.drawContours(
            thumb,
            [np.round(c * [sx, sy]).astype(np.int32) for c in contours],
            -1, (0, 255, 0), 2)
        cv2.imwrite(os.path.join(vis_dir, f"{save_bn}.jpg"),
                    cv2.cvtColor(thumb, cv2.COLOR_RGB2BGR))
        with open(os.path.join(pkl_dir, f"{save_bn}.pkl"), "wb") as f:
            pickle.dump({"contours": contours, "holes": holes,
                         "mask_shape": mask.shape}, f)
