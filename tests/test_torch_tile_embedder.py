"""The port's tile encoders, tile embedder, bag writers and patch-extraction
CLI (madeleine_torch/preprocessing/tile_embedder.py, data/io.py,
cli/extract_patch_embeddings.py) against the JAX package's on the CPU:
the 8 x 8 area pool bit for bit equal to cv2.INTER_AREA, the moments to
numpy's float32 reductions, the handcrafted features at rtol 1e-5 / atol
1e-6, a wrapped linear encoder at 1e-5, a slide's coords bit for bit and
its features at those bars without a resize, within 1e-2 relative
Frobenius with one (the port resizes with its bilinear resize, JAX with
cv2.INTER_LINEAR); bags in every format read back."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from madeleine_tpu.data import io as jio
from madeleine_tpu.preprocessing import tile_embedder as jte
from madeleine_torch.data import io as pio
from madeleine_torch.preprocessing import tile_embedder as pte
from tests.test_preprocessing import _synthetic_slide

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEAT_TOL = dict(rtol=1e-5, atol=1e-6)
RESIZED_REL_FRO = 1e-2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the numpy-moment replay is thousands of small
    ops, and a worker's eight spinning threads at each of them starve the
    other test workers on a shared CPU (and are starved by them)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def slide():
    img, tissue = _synthetic_slide()
    return img, tissue.astype(np.uint8)


def _rel_fro(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _tiles(kind, s, n=6, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 256, (n, s, s, 3), dtype=np.uint8)
    if kind == "ties":       # two neighbouring levels: cell means land on .5 often
        return rng.integers(100, 102, (n, s, s, 3), dtype=np.uint8)
    if kind == "flat":       # constant tiles: numpy's float32 sums drift most
        return np.stack([np.full((s, s, 3), v, np.uint8) for v in (245, 200, 128, 1, 255, 0)])
    tiles = np.full((n, s, s, 3), 245, np.uint8)      # background over half, tissue below
    tiles[:, s // 2:] = rng.integers(40, 200, (n, s - s // 2, s, 3))
    return tiles


# ---------------------------------------------------------------------------
# the descriptor's parts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [256, 64, 60, 16, 57, 8])
@pytest.mark.parametrize("kind", ["random", "ties"])
def test_area_pool_equals_cv2_inter_area(s, kind):
    import cv2

    tiles = _tiles(kind, s)
    want = np.stack([cv2.resize(t, (8, 8), interpolation=cv2.INTER_AREA) for t in tiles])
    got = pte.area_pool_uint8(torch.from_numpy(tiles), 8).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_area_pool_refuses_a_tile_below_its_size():
    with pytest.raises(ValueError, match="smaller"):
        pte.area_pool_uint8(torch.zeros(1, 7, 7, 3, dtype=torch.uint8), 8)


@pytest.mark.parametrize("s", [256, 64, 23])
@pytest.mark.parametrize("kind", ["random", "flat", "slide"])
def test_moments_equal_numpy_float32(s, kind):
    flat = _tiles(kind, s).reshape(6, -1, 3).astype(np.float32) / 255.0
    mean, std = pte.numpy_moments(torch.from_numpy(flat))
    np.testing.assert_array_equal(mean.numpy(), flat.mean(1))
    np.testing.assert_array_equal(std.numpy(), flat.std(1))


def test_sequential_sum_equals_numpy_on_small_values():
    """Sums through many binades (from 1e-9 up), zeros, and exact ties."""
    rng = np.random.default_rng(1)
    rows = np.concatenate([
        (rng.random((4, 3000)) * 10.0 ** rng.integers(-9, 1, (4, 1))).astype(np.float32),
        np.zeros((1, 3000), np.float32),
        np.full((1, 3000), 0.1, np.float32),
        np.repeat(np.float32([1.0, 2.0 ** -24 * 3]), 1500)[None]])
    want = np.ascontiguousarray(rows.T)[None].sum(1)[0]   # [1, P, c] over P, as flat.sum(1)
    np.testing.assert_array_equal(want, np.add.accumulate(rows, axis=1)[:, -1])
    np.testing.assert_array_equal(pte.sequential_sum_f32(torch.from_numpy(rows)).numpy(), want)


# ---------------------------------------------------------------------------
# encoders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,kind", [(64, "random"), (256, "slide"), (60, "ties")])
def test_handcrafted_encoder_equals_jax(s, kind):
    tiles = _tiles(kind, s)
    want = jte.HandcraftedEncoder(dim=64, seed=3)(tiles)
    enc = pte.HandcraftedEncoder(dim=64, seed=3, device="cpu")
    got = enc(tiles)
    assert got.dtype == np.float32 and got.shape == (6, 64)
    np.testing.assert_allclose(got, want, **FEAT_TOL)
    as_tensor = enc(torch.from_numpy(tiles))          # the embedder's call: tensor in, out
    assert isinstance(as_tensor, torch.Tensor)
    np.testing.assert_array_equal(as_tensor.numpy(), got)


def test_torch_patch_encoder_equals_jax_patch_encoder():
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    tiles = rng.integers(0, 256, (5, 16, 16, 3), dtype=np.uint8)
    w = rng.standard_normal((16 * 16 * 3, 32)).astype(np.float32) / 30
    b = rng.standard_normal(32).astype(np.float32)

    def shift(x):
        return x - 0.5

    want = jte.JaxPatchEncoder(lambda p, x: x.reshape(x.shape[0], -1) @ p["w"] + p["b"],
                               {"w": jnp.asarray(w), "b": jnp.asarray(b)}, preprocess=shift)(tiles)
    lin = torch.nn.Linear(768, 32)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T))
        lin.bias.copy_(torch.from_numpy(b))
    enc = pte.TorchPatchEncoder(torch.nn.Sequential(torch.nn.Flatten(), lin), preprocess=shift,
                                device="cpu")
    got = enc(tiles)
    assert got.dtype == np.float32 and got.shape == (5, 32)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    half = pte.TorchPatchEncoder(lambda x: x.reshape(5, -1)[:, :4].float(), dtype=torch.bfloat16,
                                 device="cpu")(tiles)
    np.testing.assert_allclose(half, (tiles.reshape(5, -1)[:, :4] / 255.0), rtol=4e-3)


def test_conch_encoder_is_gated_as_in_jax():
    with pytest.raises(ImportError, match="conch"):
        pte.make_conch_encoder(device="cpu")


def test_encoders_and_embedder_default_to_cuda():
    for make in (pte.HandcraftedEncoder, lambda: pte.TorchPatchEncoder(torch.nn.Identity()),
                 lambda: pte.TileEmbedder(bag_format="npz")):
        if torch.cuda.is_available():
            assert make().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                make()


# ---------------------------------------------------------------------------
# the embedder
# ---------------------------------------------------------------------------

def _embed_pair(tmp_path, img, mask, pixel_size, bag_format="h5", patch=64, batch=16):
    want = jte.TileEmbedder(jte.HandcraftedEncoder(dim=64), patch, 10, batch,
                            str(tmp_path / "j")).embed_tiles(img, mask, "s", pixel_size=pixel_size)
    emb = pte.TileEmbedder(pte.HandcraftedEncoder(dim=64, device="cpu"), patch, 10, batch,
                           str(tmp_path / f"p_{bag_format}"), device="cpu", bag_format=bag_format)
    got = emb.embed_tiles(img, mask, "s", pixel_size=pixel_size)
    return want, got, emb


def test_embedder_without_a_resize_equals_jax(tmp_path, slide):
    """1 um/px at 10x: 64-px regions are the tiles; every format."""
    img, mask = slide
    want, got, emb = _embed_pair(tmp_path, img, mask, 1.0)
    assert got.endswith(os.path.join("patch_embeddings", "s.h5"))
    wf, wc = jio.load_features(want), jio.load_coords(want)
    assert len(wc) > 100
    np.testing.assert_array_equal(pio.load_coords(got), wc)
    np.testing.assert_allclose(pio.load_features(got), wf, **FEAT_TOL)
    assert emb.timings["tiles"] == len(wc)
    assert {"plan", "read", "h2d", "resize", "encode", "write", "wall"} <= set(emb.timings)
    for fmt in ("npz", "bag"):
        path = pte.TileEmbedder(pte.HandcraftedEncoder(dim=64, device="cpu"), 64, 10, 16,
                                str(tmp_path / fmt), device="cpu",
                                bag_format=fmt).embed_tiles(img, mask, "s", pixel_size=1.0)
        assert path.endswith(f"s.{fmt}")
        np.testing.assert_array_equal(pio.load_coords(path), wc)
        np.testing.assert_array_equal(pio.load_features(path), pio.load_features(got))
        assert pio.bag_length(path) == len(wc)


def test_embedder_with_a_resize_is_close_to_jax(tmp_path, slide):
    """0.5 um/px: 128-px regions resized to 64 on the device (bilinear,
    rounded to uint8) against JAX's cv2.INTER_LINEAR on the host."""
    img, mask = slide
    want, got, _ = _embed_pair(tmp_path, img, mask, 0.5, bag_format="npz")
    np.testing.assert_array_equal(pio.load_coords(got), jio.load_coords(want))
    err = _rel_fro(pio.load_features(got), jio.load_features(want))
    print(f"features with a resize, relative Frobenius to JAX's: {err:.3e}")
    assert err <= RESIZED_REL_FRO


def test_h5_schema_equals_jax(tmp_path, slide):
    import h5py

    img, mask = slide
    want, got, _ = _embed_pair(tmp_path, img, mask, 1.0, batch=40)
    with h5py.File(got, "r") as g, h5py.File(want, "r") as w:
        assert sorted(g) == sorted(w) == ["coords", "features"]
        for name in w:
            assert (g[name].dtype, g[name].shape, g[name].maxshape, g[name].chunks) == \
                (w[name].dtype, w[name].shape, w[name].maxshape, w[name].chunks), name


@pytest.mark.parametrize("fmt", ["h5", "npz", "bag"])
def test_a_slide_without_tissue_writes_an_empty_bag(tmp_path, slide, fmt):
    img = slide[0][:512, :512]
    empty = np.zeros(img.shape[:2], np.uint8)
    path = pte.TileEmbedder(pte.HandcraftedEncoder(dim=48, device="cpu"), 64, 10, 16,
                            str(tmp_path), device="cpu",
                            bag_format=fmt).embed_tiles(img, empty, "e", pixel_size=1.0)
    feats, coords = pio.load_features(path), pio.load_coords(path)
    assert feats.shape == (0, 48) and feats.dtype == np.float32
    assert coords.shape == (0, 2) and pio.bag_length(path) == 0
    if fmt == "h5":
        want = jte.TileEmbedder(jte.HandcraftedEncoder(dim=48), 64, 10, 16, str(tmp_path / "j")) \
            .embed_tiles(img, empty, "e", pixel_size=1.0)
        assert jio.load_features(want).shape == (0, 48)
    if fmt == "bag":
        from madeleine_torch.native.bagio import BagReader

        reader = BagReader(path)
        assert (reader.n_rows, reader.n_cols) == (0, 48)
        assert reader.gather(np.zeros(0, np.int64)).shape == (0, 48)
        reader.close()


@pytest.mark.parametrize("fmt", ["h5", "npz", "bag"])
def test_writers_round_trip(tmp_path, fmt):
    """write_bag in each format; append_bag on .h5 (JAX's reader takes the
    port's file), refused on the fixed-header formats."""
    rng = np.random.default_rng(4)
    f1, c1 = rng.standard_normal((5, 8)).astype(np.float32), np.arange(10).reshape(5, 2)
    f2, c2 = rng.standard_normal((3, 8)).astype(np.float32), np.arange(6).reshape(3, 2) + 100
    path = str(tmp_path / "sub" / f"x.{fmt}")
    pio.write_bag(path, f1, c1)
    np.testing.assert_array_equal(pio.load_features(path), f1)
    np.testing.assert_array_equal(pio.load_coords(path), c1)
    os.remove(path)
    if fmt != "h5":
        with pytest.raises(ValueError, match="only .h5"):
            pio.append_bag(path, f1, c1)
        return
    pio.append_bag(path, f1, c1)
    pio.append_bag(path, f2, c2)
    np.testing.assert_array_equal(pio.load_features(path), np.concatenate([f1, f2]))
    np.testing.assert_array_equal(pio.load_coords(path), np.concatenate([c1, c2]))
    np.testing.assert_array_equal(jio.load_features(path), np.concatenate([f1, f2]))
    with pytest.raises(ValueError, match="bag file"):
        pio.write_bag(str(tmp_path / "x.txt"), f1)


def test_h5_without_h5py_raises_and_never_switches_format(tmp_path, monkeypatch):
    monkeypatch.setattr(pio, "h5py", None)
    with pytest.raises(RuntimeError, match=r"h5py.*\.npz or \.bag"):
        pio.write_bag(str(tmp_path / "x.h5"), np.zeros((2, 3), np.float32))
    with pytest.raises(RuntimeError, match="h5py"):
        pio.append_bag(str(tmp_path / "x.h5"), np.zeros((2, 3), np.float32))
    with pytest.raises(RuntimeError, match="h5py"):
        pte.TileEmbedder(save_path=str(tmp_path), device="cpu", bag_format="h5")
    assert os.listdir(tmp_path) == []
    with pytest.raises(ValueError, match="bag_format"):
        pte.TileEmbedder(device="cpu", bag_format="pt")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "_jax_extract_patch_embeddings", os.path.join(REPO, "bin", "extract_patch_embeddings.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_cli_equals_jax_process(tmp_path, slide):
    from PIL import Image

    from madeleine_torch.cli import extract_patch_embeddings as cli

    slide_dir = tmp_path / "slides"
    slide_dir.mkdir()
    Image.fromarray(slide[0]).save(str(slide_dir / "s1.png"))
    (slide_dir / "readme.txt").write_text("not a slide")
    jmod = _jax_cli()
    assert cli.EXTENSIONS == jmod.EXTENSIONS
    jmod.process(str(slide_dir), str(tmp_path / "j"), 10, 64, "handcrafted", 0.5)
    out = cli.main(["--slide_dir", str(slide_dir), "--local_dir", str(tmp_path / "p"),
                    "--patch_size", "64", "--device", "cpu"])
    assert os.path.basename(out) == "processing_handcrafted_nWSI_1_mag_10x_patchsize_64"
    assert _tree(tmp_path / "p") == _tree(tmp_path / "j")
    name = os.path.basename(out)
    for rel in ("segmentation/segmentation_vis/s1.jpg",
                "segmentation/geojson/s1_tissue_mask.geojson"):
        with open(os.path.join(out, rel), "rb") as f, \
                open(os.path.join(tmp_path, "j", name, rel), "rb") as g:
            assert f.read() == g.read(), rel
    got = os.path.join(out, "patch_embeddings", "s1.h5")
    want = os.path.join(tmp_path, "j", name, "patch_embeddings", "s1.h5")
    np.testing.assert_array_equal(pio.load_coords(got), jio.load_coords(want))
    assert _rel_fro(pio.load_features(got), jio.load_features(want)) <= RESIZED_REL_FRO
    # the other formats: the same bag
    for fmt in ("npz", "bag"):
        o = cli.main(["--slide_dir", str(slide_dir), "--local_dir", str(tmp_path / fmt),
                      "--patch_size", "64", "--device", "cpu", "--bag_format", fmt])
        path = os.path.join(o, "patch_embeddings", f"s1.{fmt}")
        np.testing.assert_array_equal(pio.load_features(path), pio.load_features(got))
        np.testing.assert_array_equal(pio.load_coords(path), pio.load_coords(got))
