"""The port's slide readers, tissue-grid patching, tissue segmentation and
segmentation tile datasets (madeleine_torch/preprocessing/{wsi, patching,
segmentation, seg_dataset}.py) against the JAX package's on the same
synthetic slide: plans, masks, contours and artifacts bit for bit; tiles
bit for bit where no resize is needed, within one uint8 level of cv2's
INTER_LINEAR where one is."""

import json
import os
import pickle

import numpy as np
import pytest

from madeleine_tpu.preprocessing import patching as jpatch
from madeleine_tpu.preprocessing import seg_dataset as jsegds
from madeleine_tpu.preprocessing import segmentation as jseg
from madeleine_tpu.preprocessing import wsi as jwsi
from madeleine_torch.preprocessing import patching as ppatch
from madeleine_torch.preprocessing import seg_dataset as psegds
from madeleine_torch.preprocessing import segmentation as pseg
from madeleine_torch.preprocessing import wsi as pwsi
from tests.test_preprocessing import _synthetic_slide


@pytest.fixture(scope="module")
def slide():
    img, tissue = _synthetic_slide()
    return img, tissue.astype(np.uint8)


@pytest.fixture(scope="module")
def png_slide(tmp_path_factory, slide):
    from PIL import Image

    path = str(tmp_path_factory.mktemp("png") / "s1.png")
    Image.fromarray(slide[0]).save(path)
    return path


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("loc,size", [((100, 50), (64, 32)), ((2000, 1500), (96, 64)),
                                      ((-20, -10), (48, 40)), ((3000, 10), (16, 16))])
def test_read_region_equals_jax_in_and_out_of_bounds(slide, loc, size):
    img = slide[0]
    want = jwsi.NumpyWSI(img, 0.5).read_region(loc, 0, size)
    got = pwsi.NumpyWSI(img, 0.5).read_region(loc, 0, size)
    assert got.dtype == np.uint8 and got.shape == (size[1], size[0], 3)
    np.testing.assert_array_equal(got, want)


def test_wsi_factory_dispatch_and_pixel_size(slide, png_slide):
    img = slide[0]
    assert isinstance(pwsi.wsi_factory(img, 0.5), pwsi.NumpyWSI)
    w = pwsi.NumpyWSI(img)
    assert pwsi.wsi_factory(w) is w
    with pytest.raises(TypeError):
        pwsi.wsi_factory(3)
    got, want = pwsi.wsi_factory(png_slide), jwsi.wsi_factory(png_slide)
    assert type(got).__name__ == type(want).__name__ == "PILWSI"
    assert got.dimensions == want.dimensions == (img.shape[1], img.shape[0])
    assert got.best_level_for_downsample(2.0) == want.best_level_for_downsample(2.0) == 0
    for loc in ((0, 0), (1990, 1500)):
        np.testing.assert_array_equal(got.read_region(loc, 0, (64, 64)),
                                      want.read_region(loc, 0, (64, 64)))
    np.testing.assert_array_equal(got.get_thumbnail(256, 192), want.get_thumbnail(256, 192))
    np.testing.assert_array_equal(pwsi.NumpyWSI(img).get_thumbnail(256, 192),
                                  jwsi.NumpyWSI(img).get_thumbnail(256, 192))
    # the pixel size: the reader's own, then the default, else ValueError; as JAX's
    for p, j in ((pwsi.NumpyWSI(img, 0.25), jwsi.NumpyWSI(img, 0.25)), (got, want)):
        for default in (None, 0.5):
            try:
                expect = jwsi.get_pixel_size(j, default=default)
            except ValueError:
                with pytest.raises(ValueError, match="pixel size"):
                    pwsi.get_pixel_size(p, default=default)
                continue
            assert pwsi.get_pixel_size(p, default=default) == expect


def test_tiff_resolution_gives_the_pixel_size(tmp_path, slide):
    from PIL import Image

    path = str(tmp_path / "s.tif")
    Image.fromarray(slide[0][:64, :64]).save(path, dpi=(50800, 50800))
    got, want = pwsi.PILWSI(path), jwsi.PILWSI(path)
    assert pwsi.get_pixel_size(got) == jwsi.get_pixel_size(want) == pytest.approx(0.5)


def test_openslide_is_gated_as_in_jax():
    assert pwsi.HAVE_OPENSLIDE == jwsi.HAVE_OPENSLIDE
    if not pwsi.HAVE_OPENSLIDE:
        with pytest.raises(ImportError, match="openslide"):
            pwsi.OpenSlideWSI(None)


# ---------------------------------------------------------------------------
# the tissue grid
# ---------------------------------------------------------------------------

PLANS = {
    "area": dict(patch_size=128, src_pixel_size=0.5, dst_pixel_size=1.0),
    "corner": dict(patch_size=128, src_pixel_size=0.5, dst_pixel_size=1.0, corner_mode=True),
    "overlap": dict(patch_size=96, src_pixel_size=0.5, dst_pixel_size=1.0, overlap=32),
    "mag": dict(patch_size=64, src_pixel_size=0.5, mag=10),
    "mag_low_frac": dict(patch_size=64, src_pixel_size=0.25, mag=20, min_tissue_frac=0.0001),
    "no_mask": dict(patch_size=256, src_pixel_size=1.0),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_patcher_plan_equals_jax(slide, name):
    img, tissue = slide
    kw = dict(PLANS[name])
    mask = None if name == "no_mask" else tissue
    want = jpatch.WSIPatcher(img, mask=mask, **kw)
    got = ppatch.WSIPatcher(img, mask=mask, **kw)
    assert (got.rows, got.cols, got.level_patch_size, got.src_patch_size) == \
        (want.rows, want.cols, want.level_patch_size, want.src_patch_size)
    assert got.coords.dtype == np.int64 and len(got) > 0
    np.testing.assert_array_equal(got.coords, want.coords)


def test_tiles_bit_for_bit_without_a_resize(slide):
    img, tissue = slide
    want = jpatch.WSIPatcher(img, 128, 1.0, dst_pixel_size=1.0, mask=tissue)
    got = ppatch.WSIPatcher(img, 128, 1.0, dst_pixel_size=1.0, mask=tissue)
    tiles = np.stack([t for t, _, _ in got])
    np.testing.assert_array_equal(tiles, np.stack([t for t, _, _ in want]))
    np.testing.assert_array_equal(got.read_regions(range(len(got))).numpy(), tiles)
    assert [(x, y) for _, x, y in got] == [tuple(c) for c in want.coords]


def test_tiles_within_one_level_of_cv2_with_a_resize(slide):
    """src 256 px -> 128 px (and 128 -> 64): the port's bilinear resize on
    the host, against JAX's cv2.INTER_LINEAR tiles; the read_regions +
    resize route gives the same tiles as get_tile."""
    img, tissue = slide
    shares = {}
    for ps, pxs in ((128, 0.5), (64, 0.5)):
        want = jpatch.WSIPatcher(img, ps, pxs, dst_pixel_size=1.0, mask=tissue)
        got = ppatch.WSIPatcher(img, ps, pxs, dst_pixel_size=1.0, mask=tissue)
        a = np.stack([t for t, _, _ in want]).astype(np.int16)
        b = np.stack([t for t, _, _ in got])
        assert b.shape == a.shape == (len(want), ps, ps, 3)
        diff = np.abs(b.astype(np.int16) - a)
        assert diff.max() <= 1
        shares[ps] = float((diff > 0).mean())
        batch = got.resize(got.read_regions(range(len(got)))).numpy()
        np.testing.assert_array_equal(batch, b)
    print(f"share of tile values one level from cv2's: {shares}")
    assert all(s < 0.2 for s in shares.values())


def test_visualize_grid_equals_jax(tmp_path, slide):
    import cv2

    img, tissue = slide
    kw = dict(patch_size=128, src_pixel_size=0.5, dst_pixel_size=1.0, mask=tissue)
    jpatch.WSIPatcher(img, **kw).visualize_grid(str(tmp_path / "j.png"), thumb_width=400)
    ppatch.WSIPatcher(img, **kw).visualize_grid(str(tmp_path / "p.png"), thumb_width=400)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "p.png")),
                                  cv2.imread(str(tmp_path / "j.png")))


# ---------------------------------------------------------------------------
# segmentation
# ---------------------------------------------------------------------------

def _same_contours(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _same_segmentation(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    _same_contours(got[1], want[1])
    assert len(got[2]) == len(want[2])
    for g, w in zip(got[2], want[2]):
        _same_contours(g, w)


def test_otsu_segmentation_and_artifacts_equal_jax(tmp_path, slide):
    img = slide[0]
    want = jseg.TissueSegmenter(save_path=str(tmp_path / "j"), min_area_um2=10_000) \
        .segment_tissue(img, pixel_size=0.5, save_bn="s1")
    seg = pseg.TissueSegmenter(save_path=str(tmp_path / "p"), min_area_um2=10_000)
    got = seg.segment_tissue(img, pixel_size=0.5, save_bn="s1")
    _same_segmentation(got, want)
    assert len(got[1]) == 2 and got[0].sum() > 0
    assert set(seg.timings) == {"thumbnail", "otsu_contours", "save"}
    for rel in ("segmentation_vis/s1.jpg", "geojson/s1_tissue_mask.geojson"):
        with open(tmp_path / "p" / rel, "rb") as f, open(tmp_path / "j" / rel, "rb") as g:
            assert f.read() == g.read(), rel
    with open(tmp_path / "p/segmentation_pkl/s1.pkl", "rb") as f:
        pk = pickle.load(f)
    with open(tmp_path / "j/segmentation_pkl/s1.pkl", "rb") as f:
        jk = pickle.load(f)
    assert pk["mask_shape"] == jk["mask_shape"]
    _same_contours(pk["contours"], jk["contours"])
    with open(tmp_path / "p/geojson/s1_tissue_mask.geojson") as f:
        assert json.load(f)["type"] == "FeatureCollection"


def test_otsu_with_a_fixed_threshold_and_holes(slide):
    """A ring of tissue: its hole is kept, as in JAX; and sat_thresh."""
    img = slide[0].copy()
    img[600:800, 1300:1700] = 245       # a hole through the second blob
    for kw in (dict(min_area_um2=10_000), dict(min_area_um2=10_000, sat_thresh=40)):
        want = jseg.TissueSegmenter(**kw).segment_tissue(img, pixel_size=0.5)
        got = pseg.TissueSegmenter(**kw).segment_tissue(img, pixel_size=0.5)
        _same_segmentation(got, want)


def _stub_model(tiles):
    return (tiles.mean(axis=-1) < 220).astype(np.float32)


def test_model_backend_equals_jax_without_a_resize(slide):
    """At 1 um/px the 512-px tiles are read as they are: the stitched mask
    and its contours equal JAX's."""
    img = slide[0]
    kw = dict(backend="model", model_fn=_stub_model, min_area_um2=10_000, batch_size=8)
    want = jseg.TissueSegmenter(**kw).segment_tissue(img, pixel_size=1.0)
    got = pseg.TissueSegmenter(**kw).segment_tissue(img, pixel_size=1.0)
    _same_segmentation(got, want)
    assert got[0].sum() > 0


def test_model_backend_with_a_resize(slide):
    """At 0.5 um/px each 1024-px read is resized to 512 (the port's bilinear
    within one level of cv2's): the stub's mask agrees but for pixels on
    its threshold."""
    img = slide[0]
    kw = dict(backend="model", model_fn=_stub_model, min_area_um2=10_000, batch_size=8)
    want = jseg.TissueSegmenter(**kw).segment_tissue(img, pixel_size=0.5)
    got = pseg.TissueSegmenter(**kw).segment_tissue(img, pixel_size=0.5)
    assert got[0].shape == want[0].shape
    differ = float((got[0] != want[0]).mean())
    print(f"model-backend mask pixels that differ with a resize: {differ:.2e}")
    assert differ < 1e-3 and len(got[1]) == len(want[1])


def test_contour_helpers_equal_jax(slide):
    tissue = slide[1]
    want = jseg.mask_to_contours(tissue, 1.0, min_area_um2=10_000)
    got = pseg.mask_to_contours(tissue, 1.0, min_area_um2=10_000)
    _same_contours(got[0], want[0])
    assert got[2] == want[2]
    np.testing.assert_array_equal(pseg.contours_to_mask(tissue.shape, got[0], got[1]),
                                  jseg.contours_to_mask(tissue.shape, want[0], want[1]))
    assert pseg.contours_to_geojson(got[0], got[1], 2.0) == \
        jseg.contours_to_geojson(want[0], want[1], 2.0)


def test_deeplab_adapter_needs_torchvision():
    try:
        import torchvision  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="torchvision"):
            pseg.make_torch_deeplab_fn()
    else:
        fn = pseg.make_torch_deeplab_fn(device="cpu")
        assert fn(np.zeros((1, 64, 64, 3), np.uint8)).shape == (1, 64, 64)


def test_model_backend_needs_a_model_fn():
    with pytest.raises(ValueError, match="model_fn"):
        pseg.TissueSegmenter(backend="model")


# ---------------------------------------------------------------------------
# segmentation tile datasets
# ---------------------------------------------------------------------------

def test_seg_datasets_equal_jax(tmp_path, slide):
    from PIL import Image

    img, tissue = slide
    kw = dict(patch_size=128, src_pixel_size=1.0, mask=tissue)
    want = list(jsegds.SegWSIDataset(jpatch.WSIPatcher(img, **kw), batch_size=5))
    ds = psegds.SegWSIDataset(ppatch.WSIPatcher(img, **kw), batch_size=5)
    got = list(ds)
    assert len(ds) == sum(len(c) for _, c in got) and len(got) == len(want) > 1
    for (gt, gc), (wt, wc) in zip(got, want):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gc, wc)

    tdir = tmp_path / "tiles"
    tdir.mkdir()
    for x, y in ((0, 0), (128, 0), (0, 128), (256, 512)):
        Image.fromarray(img[y:y + 64, x:x + 64]).save(str(tdir / f"t_{x}_{y}.png"))
    (tdir / "notes.txt").write_text("not a tile")
    want = list(jsegds.SegFileDataset(str(tdir), batch_size=3))
    fds = psegds.SegFileDataset(str(tdir), batch_size=3)
    got = list(fds)
    assert len(fds) == 4 and len(got) == len(want) == 2
    for (gt, gc), (wt, wc) in zip(got, want):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gc, wc)
