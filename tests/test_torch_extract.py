"""The port's extraction CLI on the CPU against JAX `run_inference` over the
same .npz bags and weights (rtol 1e-4 / atol 1e-5; slide ids exactly)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from madeleine_tpu.data.datasets import BucketedBagLoader
from madeleine_tpu.eval.inference import run_inference as jax_run_inference
from madeleine_torch.models.factory import export_torch_checkpoint
from madeleine_torch.utils.file_utils import load_pkl
from tests.torch_port_helpers import configs, jax_params, port_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_extract_cli_matches_jax_run_inference(tmp_path):
    jcfg, cfg = configs()
    params = jax_params(jcfg, seed=0)
    model_dir = tmp_path / "models" / "MADELEINE"
    model_dir.mkdir(parents=True)
    export_torch_checkpoint(port_model(cfg, params), str(model_dir / "model.pt"))
    cfg.save(str(model_dir / "model_config.json"))
    bag_dir = tmp_path / "cohort" / "patch_embeddings"
    bag_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for name, n in (("slide_b", 300), ("slide_a", 45), ("slide_c", 700)):
        np.savez(bag_dir / f"{name}.npz",
                 features=rng.standard_normal((n, 64)).astype(np.float32))

    proc = subprocess.run(
        [sys.executable, "-m", "madeleine_torch.cli.extract_slide_embeddings",
         "--local_dir", str(tmp_path / "cohort"), "--model_dir", str(tmp_path / "models"),
         "--no_download", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = load_pkl(str(tmp_path / "cohort" / "madeleine_slide_embeddings.pkl"))

    want, _ = jax_run_inference(jax.tree_util.tree_map(jnp.asarray, params), jcfg,
                                BucketedBagLoader(str(bag_dir)), verbose=False)
    assert set(got) == {"embeds", "slide_ids"}
    assert got["slide_ids"] == want["slide_ids"]
    np.testing.assert_allclose(got["embeds"], want["embeds"], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("fmt", ["bag-float32", "bag-bfloat16", "h5", "npz"])
def test_bag_files_read_like_the_jax_package(tmp_path, fmt):
    from madeleine_tpu.data.io import load_features as jax_load_features
    from madeleine_tpu.data.io import write_bag
    from madeleine_tpu.native.bagio import write_bag_file
    from madeleine_torch.data.io import bag_length, load_features

    feats = np.random.default_rng(1).standard_normal((37, 24)).astype(np.float32)
    if fmt.startswith("bag"):
        path = str(tmp_path / "s.bag")
        write_bag_file(path, feats, coords=np.zeros((37, 2), np.int64),
                       dtype=fmt.split("-")[1])
    else:
        path = str(tmp_path / f"s.{fmt}")
        write_bag(path, feats[None] if fmt == "h5" else feats)  # h5: leading singleton dim
    got = load_features(path)
    np.testing.assert_array_equal(got, jax_load_features(path))
    assert bag_length(path) == 37 and got.shape == (37, 24) and got.dtype == np.float32


def test_bucketed_loader_matches_the_jax_loader(tmp_path):
    from madeleine_torch.data.datasets import BucketedBagLoader as PortLoader
    from madeleine_torch.data.io import list_bags

    rng = np.random.default_rng(2)
    for i, n in enumerate((5, 40, 33, 70, 8)):
        np.savez(tmp_path / f"s{i}.npz", features=rng.standard_normal((n, 4)).astype(np.float32))
    np.savez(tmp_path / "s0dup.npz", features=np.zeros((3, 4), np.float32))
    (tmp_path / "notes.txt").write_text("not a bag")
    assert list(list_bags(str(tmp_path))) == sorted(
        f"s{i}.npz" for i in (0, "0dup", 1, 2, 3, 4))
    kw = dict(buckets=(16, 64), tokens_per_batch=128)
    for got, want in zip(PortLoader(str(tmp_path), **kw),
                         BucketedBagLoader(str(tmp_path), **kw), strict=True):
        assert got["slide_ids"] == want["slide_ids"] and got["n_valid"] == want["n_valid"]
        np.testing.assert_array_equal(got["feats"], want["feats"])
        np.testing.assert_array_equal(got["mask"], want["mask"])
