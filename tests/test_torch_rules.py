"""Rules of the port: it imports neither JAX nor the JAX package; pandas,
ml_dtypes and sklearn, which the card's machine lacks, not at all; PIL and
cv2, which it has (chip_smoke.py's probe phase), only inside the functions
that need them (`OPTIONAL_IMPORTS`), so importing the port loads none of
these; and its entry points never fall back to the CPU silently."""

import ast
import os
import subprocess
import sys

import pytest

from madeleine_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "madeleine_tpu")
ABSENT_ON_THE_CARD = ("pandas", "ml_dtypes", "sklearn", "PIL", "cv2")
# The imports of such a package that a port source may hold, each inside a
# function: the heatmap's optional thumbnail overlay (PIL's resize; without
# PIL it raises ImportError naming PIL,
# tests/test_torch_heatmap.py::test_thumbnail_overlay_and_pil_absent), and
# the slide side of preprocessing where the JAX package imports them: PIL to
# open an image file, a tile file and CONCH's transform, cv2 for
# thumbnails, contours, Otsu and the grid overlay; and chip_smoke.py's slide
# phase, which holds the card's resized tiles against cv2's on the host.
OPTIONAL_IMPORTS = {("madeleine_torch/eval/heatmap.py", "PIL"),
                    ("chip_smoke.py", "cv2"),
                    ("madeleine_torch/preprocessing/wsi.py", "PIL"),
                    ("madeleine_torch/preprocessing/wsi.py", "cv2"),
                    ("madeleine_torch/preprocessing/patching.py", "cv2"),
                    ("madeleine_torch/preprocessing/segmentation.py", "cv2"),
                    ("madeleine_torch/preprocessing/seg_dataset.py", "PIL"),
                    ("madeleine_torch/preprocessing/tile_embedder.py", "PIL")}


def _port_sources():
    for root, _, files in os.walk(os.path.join(REPO, "madeleine_torch")):
        for fn in files:
            if fn.endswith(".py"):
                yield os.path.join(root, fn)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_imports_in_port_sources():
    bad = [(os.path.relpath(p, REPO), m) for p in _port_sources()
           for m in _imported_roots(p) if m in FORBIDDEN]
    assert not bad, bad


def test_no_pandas_or_ml_dtypes_in_port_sources():
    """Neither the port's sources and chip_smoke.py import them, nor does
    importing the whole port load them."""
    bad = [(os.path.relpath(p, REPO), m) for p in _port_sources()
           for m in _imported_roots(p) if m in ABSENT_ON_THE_CARD]
    assert not set(bad) - OPTIONAL_IMPORTS, bad
    modules = sorted(
        os.path.relpath(p, REPO)[:-3].replace(os.sep, ".").removesuffix(".__init__")
        for p in _port_sources() if not p.endswith("chip_smoke.py"))
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {ABSENT_ON_THE_CARD!r}]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_optional_imports_sit_inside_functions():
    """Each import of OPTIONAL_IMPORTS is in a function's body, never at a
    module's or a class's top level."""
    for rel, module in sorted(OPTIONAL_IMPORTS):
        tree = ast.parse(open(os.path.join(REPO, rel)).read(), rel)
        inside = {id(n) for f in ast.walk(tree)
                  if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
                  for n in ast.walk(f)}
        found = [n for n in ast.walk(tree) if isinstance(n, (ast.Import, ast.ImportFrom))
                 and module in ([a.name.split(".")[0] for a in n.names]
                                if isinstance(n, ast.Import)
                                else [(n.module or "").split(".")[0]])]
        assert found, (rel, module)
        assert all(id(n) in inside for n in found), (rel, module)


def test_importing_the_whole_port_loads_no_jax():
    modules = sorted(
        os.path.relpath(p, REPO)[:-3].replace(os.sep, ".").removesuffix(".__init__")
        for p in _port_sources() if not p.endswith("chip_smoke.py"))
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'madeleine_tpu')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_default_device_is_cuda_and_raises_without_it():
    import torch

    assert resolve_device("cpu").type == "cpu"

    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device("cuda")


def test_entry_points_default_to_cuda():
    import inspect

    from madeleine_torch.eval.inference import run_inference
    from madeleine_torch.eval.linear_probe import L2LogisticRegression, eval_single_task
    from madeleine_torch.models.factory import create_model, create_model_from_pretrained
    from madeleine_torch.preprocessing.segmentation import make_torch_deeplab_fn
    from madeleine_torch.preprocessing.tile_embedder import (HandcraftedEncoder,
                                                             TileEmbedder,
                                                             TorchPatchEncoder,
                                                             make_conch_encoder)
    from madeleine_torch.preprocessing.vit import TorchViTEncoder
    from madeleine_torch.serve.server import EmbeddingService
    from madeleine_torch.setup import setup_model

    for fn in (run_inference, create_model, create_model_from_pretrained,
               EmbeddingService.__init__, eval_single_task, L2LogisticRegression.__init__,
               TorchViTEncoder.__init__, HandcraftedEncoder.__init__, TorchPatchEncoder.__init__,
               TileEmbedder.__init__, make_conch_encoder, make_torch_deeplab_fn, setup_model):
        assert inspect.signature(fn).parameters["device"].default is None, fn


@pytest.mark.parametrize("cli", ["serve", "extract_slide_embeddings", "pretrain",
                                 "run_linear_probing", "extract_mean_embs",
                                 "extract_attention_maps", "extract_patch_embeddings"])
def test_cli_device_flag_defaults_to_cuda(cli):
    proc = subprocess.run([sys.executable, "-m", f"madeleine_torch.cli.{cli}", "--help"],
                          cwd=REPO, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "--device" in proc.stdout
    src = open(os.path.join(REPO, "madeleine_torch", "cli", f"{cli}.py")).read()
    assert 'add_argument("--device", type=str, default="cuda")' in src


def test_data_and_trace_tools_run_without_pandas(tmp_path):
    """`python -m madeleine_torch.tools.build_dataset_csvs` and
    `python -m madeleine_torch.tools.profile_summary`, the counterparts of
    the JAX package's pandas and JAX scripts, run in a process where pandas
    cannot be imported (as on the card's machine)."""
    import json

    feats = tmp_path / "feats"
    feats.mkdir()
    for name in ("c1_HE.npz", "c1_ER.npz", "c2_HE_val.h5"):
        (feats / name).write_bytes(b"")
    prof = tmp_path / "prof"
    prof.mkdir()
    (prof / "trace.json").write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "gpu_user_annotation", "name": "step_fn", "ts": 0, "dur": 2000},
        {"ph": "X", "cat": "kernel", "name": "gemm_kernel", "ts": 10, "dur": 1500}]}))
    out = tmp_path / "ACROBAT.csv"
    code = ("import runpy, sys\n"
            "sys.modules['pandas'] = None\n"
            f"sys.argv = ['x', '--scan_features', {str(feats)!r}, '--out', {str(out)!r}]\n"
            "runpy.run_module('madeleine_torch.tools.build_dataset_csvs', run_name='__main__')\n"
            f"sys.argv = ['x', {str(prof)!r}]\n"
            "runpy.run_module('madeleine_torch.tools.profile_summary', run_name='__main__')\n"
            "assert 'pandas' not in [m.split('.')[0] for m in sys.modules if sys.modules[m]]\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert out.read_text() == ("slide_id,HE,HER2,PGR,KI67,ER,split\n"
                               "c1,1,0,0,0,1,train\nc2,1,0,0,0,0,val\n")
    assert "step_fn device time: 2.0 ms/step  (1 steps captured)" in proc.stdout
    assert "1.50 ms/step 100.0%  gemm_kernel" in proc.stdout
