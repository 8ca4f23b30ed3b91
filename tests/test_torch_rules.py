"""Rules of the port: it imports neither JAX nor the JAX package, and its
entry points never fall back to the CPU silently."""

import ast
import os
import subprocess
import sys

import pytest

from madeleine_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "madeleine_tpu")


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
    from madeleine_torch.models.factory import create_model, create_model_from_pretrained
    from madeleine_torch.serve.server import EmbeddingService

    for fn in (run_inference, create_model, create_model_from_pretrained,
               EmbeddingService.__init__):
        assert inspect.signature(fn).parameters["device"].default is None, fn


@pytest.mark.parametrize("cli", ["serve", "extract_slide_embeddings", "pretrain"])
def test_cli_device_flag_defaults_to_cuda(cli):
    proc = subprocess.run([sys.executable, "-m", f"madeleine_torch.cli.{cli}", "--help"],
                          cwd=REPO, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "--device" in proc.stdout
    src = open(os.path.join(REPO, "madeleine_torch", "cli", f"{cli}.py")).read()
    assert 'add_argument("--device", type=str, default="cuda")' in src
