"""The port's heatmaps (`madeleine_torch/eval/heatmap.py`) and attention-map
CLI on the CPU against the JAX package's: `attention_to_grid` bit for bit;
the PNG, written without PIL and decoded with PIL here, pixel for pixel
JAX's `save_heatmap`; the CLI's raw logits against JAX's
`encode_with_attention` at rtol 1e-4 / atol 1e-5 (f32) and its PNGs within
one level of JAX's."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from madeleine_tpu.data.io import write_bag
from madeleine_tpu.eval import heatmap as jax_hm
from madeleine_tpu.models.madeleine import encode_with_attention as jax_encode_with_attention
from madeleine_tpu.native.bagio import write_bag_file
from madeleine_torch.cli import extract_attention_maps
from madeleine_torch.eval import heatmap as hm
from madeleine_torch.models.factory import export_torch_checkpoint
from tests.torch_port_helpers import configs, jax_params, port_model

PATCH = 256


def _coords(rng, n, side):
    """n distinct patch origins on a side x side grid, offset from 0."""
    cells = rng.choice(side * side, n, replace=False)
    return np.stack([cells % side, cells // side], 1).astype(np.int64) * PATCH + 3 * PATCH


def _pixels(path):
    with Image.open(path) as img:
        assert img.mode == "RGB"
        return np.asarray(img)


@pytest.mark.parametrize("shape,softmax", [((40, 3), True), ((40, 3), False), ((40,), True)])
def test_attention_to_grid_bit_for_bit(shape, softmax):
    rng = np.random.default_rng(0)
    coords = _coords(rng, shape[0], 9)
    att = rng.standard_normal(shape).astype(np.float32) * 3
    got, got_origin = hm.attention_to_grid(coords, att, PATCH, softmax=softmax)
    want, want_origin = jax_hm.attention_to_grid(coords, att, PATCH, softmax=softmax)
    assert got.dtype == want.dtype and got_origin == want_origin
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("head,cell_px", [(None, 8), (1, 8), (None, 3)])
def test_png_equals_jax_save_heatmap(tmp_path, head, cell_px):
    rng = np.random.default_rng(1)
    coords = _coords(rng, 50, 11)
    att = rng.standard_normal((50, 4)).astype(np.float32) * 2
    got = hm.save_heatmap(str(tmp_path / "port" / "m.png"), coords, att, PATCH, head=head,
                          cell_px=cell_px)
    want = jax_hm.save_heatmap(str(tmp_path / "jax" / "m.png"), coords, att, PATCH, head=head,
                               cell_px=cell_px)
    np.testing.assert_array_equal(_pixels(got), _pixels(want))
    assert hm.png_size(got) == Image.open(want).size


def test_thumbnail_overlay_and_pil_absent(tmp_path, monkeypatch):
    rng = np.random.default_rng(2)
    coords = _coords(rng, 30, 8)
    att = rng.standard_normal((30, 2)).astype(np.float32)
    thumb = rng.integers(0, 256, (50, 70, 3), dtype=np.uint8)
    got = hm.save_heatmap(str(tmp_path / "p.png"), coords, att, PATCH, thumbnail=thumb)
    want = jax_hm.save_heatmap(str(tmp_path / "j.png"), coords, att, PATCH, thumbnail=thumb)
    np.testing.assert_array_equal(_pixels(got), _pixels(want))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        hm.save_heatmap(str(tmp_path / "x.png"), coords, att, PATCH, thumbnail=thumb)
    hm.save_heatmap(str(tmp_path / "y.png"), coords, att, PATCH)   # no PIL needed


def test_attention_maps_cli(tmp_path):
    """Three slides with coords (.npz and .bag) and one without: the CLI
    with --device cpu against JAX's encode_with_attention and save_heatmap."""
    jcfg, cfg = configs()
    params = jax_params(jcfg, seed=3)
    model_dir = tmp_path / "models" / "MADELEINE"
    model_dir.mkdir(parents=True)
    export_torch_checkpoint(port_model(cfg, params), str(model_dir / "model.pt"))
    cfg.save(str(model_dir / "model_config.json"))
    bag_dir = tmp_path / "cohort" / "patch_embeddings"
    bag_dir.mkdir(parents=True)
    rng = np.random.default_rng(4)
    bags = {}
    for name, n, ext in (("slide_a", 45, ".npz"), ("slide_b", 300, ".bag"),
                         ("slide_c", 120, ".npz"), ("slide_d", 60, ".npz")):
        feats = rng.standard_normal((n, 64)).astype(np.float32)
        coords = None if name == "slide_d" else _coords(rng, n, 25)
        if ext == ".bag":
            write_bag_file(str(bag_dir / (name + ext)), feats, coords=coords)
        else:
            write_bag(str(bag_dir / (name + ext)), feats, coords=coords)
        bags[name] = (feats, coords)

    argv = ["--local_dir", str(tmp_path / "cohort"), "--model_dir", str(tmp_path / "models"),
            "--no_download"]
    out = extract_attention_maps.main(argv + ["--device", "cpu"])
    assert sorted(out["maps"]) == ["slide_a", "slide_b", "slide_c"]
    # JAX's logits of the three bags in one padded call (a token's logits
    # do not depend on the mask)
    sids = sorted(out["maps"])
    t = max(len(bags[s][0]) for s in sids)
    x = np.stack([np.pad(bags[s][0], ((0, t - len(bags[s][0])), (0, 0))) for s in sids])
    mask = np.arange(t)[None] < np.array([len(bags[s][0]) for s in sids])[:, None]
    _, raw = jax.jit(lambda p, x, m: jax_encode_with_attention(p, jcfg, x, mask=m))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(mask))
    for i, (sid, path) in enumerate(sorted(out["maps"].items())):
        feats, coords = bags[sid]
        want_raw = np.asarray(raw[i, :len(feats)])
        np.testing.assert_allclose(out["logits"][sid], want_raw, rtol=1e-4, atol=1e-5)
        want = jax_hm.save_heatmap(str(tmp_path / "jax" / f"{sid}.png"), coords, want_raw, PATCH)
        assert os.path.dirname(path) == str(tmp_path / "cohort" / "attention_maps")
        diff = np.abs(_pixels(path).astype(int) - _pixels(want).astype(int))
        assert diff.max() <= 1, (sid, diff.max())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            extract_attention_maps.main(argv)
