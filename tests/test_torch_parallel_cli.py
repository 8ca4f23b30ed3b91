"""The pretrain CLI data-parallel on the CPU: ``torchrun --nproc_per_node 2
-m madeleine_torch.cli.pretrain ... --device cpu`` (Gloo), the flags of
tests/test_torch_pretrain.py with a global batch of 6 (3 rows a rank).
It finishes, only rank 0 writes the results dir, both ranks end with the
same weights, a resumed world-2 run's model.pt equals an uninterrupted
one's bit for bit, and a --mesh_shape other than the world size raises on
every rank."""

import json
import os
import re
import subprocess
import sys

import pytest
import torch

from tests import test_torch_pretrain as TP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _torchrun(argv, log_path):
    """(return code, output) of the CLI under torchrun with 2 processes."""
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=REPO)
    with open(log_path, "w") as log:
        rc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                             "--nproc_per_node", "2", "-m", "madeleine_torch.cli.pretrain",
                             *argv], cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT,
                            timeout=600).returncode
    return rc, open(log_path).read()


def _digests(out):
    return dict(re.findall(r"\* rank (\d)/2: parameters sha256 ([0-9a-f]{64})", out))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The cohort and three world-2 runs: A (2 epochs, a checkpoint each,
    the downstream pass), B (A resumed to 3 epochs), C (3 epochs straight)."""
    root = str(tmp_path_factory.mktemp("cohort"))
    _, _, down = TP._write_cohort(root, 11, 16, lengths=(20, 60))
    out = {}
    for name, epochs, extra in (("a", 2, ("--downstream_dir", down)),
                                ("b", 3, ("--resume", None)), ("c", 3, ())):
        if extra[:1] == ("--resume",):
            extra = ("--resume", os.path.join(out["a"]["results"], "train_state"))
        argv = TP._argv(root, os.path.join(root, f"results_{name}"), epochs, "--batch_size", "6",
                        *extra)
        rc, log = _torchrun(argv, os.path.join(root, f"{name}.log"))
        assert rc == 0, log[-4000:]
        results = [ln.split(": ", 1)[1] for ln in log.splitlines()
                   if ln.startswith("* Results dir: ")]
        out[name] = {"results": results[0] if results else None, "log": log,
                     "n_results_lines": len(results)}
    return root, out


def test_world_2_run_finishes_and_only_rank_0_writes(runs):
    """Run A: one "Results dir" line (rank 0's), the results dir holds the
    artifacts once: one metrics record per epoch and one for the downstream
    pass (rank 1 logs none), the downstream pkl with every slide."""
    _, out = runs
    a = out["a"]
    assert a["n_results_lines"] == 1 and "Data parallel over 2 processes (gloo)" in a["log"]
    names = set(os.listdir(a["results"]))
    assert {"config.json", "model_config.txt", "model.pt", "model_config.json",
            "downstream.pkl", "train_state", "train_state.meta.json"} <= names
    records = [json.loads(ln) for ln in open(os.path.join(a["results"], "metrics.jsonl"))]
    assert [r["epoch"] for r in records if "steps" in r] == [0, 1]
    assert sum("downstream" in r for r in records) == 1 and len(records) == 4
    for r in records:
        if "steps" in r:
            assert r["n_steps"] == 2 and r["n_skipped"] == 0 and len(r["loader_ms"]) == 2
    assert a["log"].count("Done with epoch") == 2


def test_world_2_ranks_end_with_equal_weights(runs):
    """Every run's two ranks print the same parameters' sha256, and it is
    the digest of rank 0's model.pt."""
    _, out = runs
    for name, run in out.items():
        digests = _digests(run["log"])
        assert set(digests) == {"0", "1"} and digests["0"] == digests["1"], name
    from madeleine_torch.cli.pretrain import param_digest
    from madeleine_torch.config import MadeleineConfig
    from madeleine_torch.models.factory import create_model

    c = out["c"]["results"]
    cfg = MadeleineConfig.from_json(os.path.join(c, "model_config.json"))
    _, model = create_model(cfg, checkpoint_path=os.path.join(c, "model.pt"), device="cpu")
    assert param_digest(model) == _digests(out["c"]["log"])["0"]


def test_world_2_resume_equals_an_uninterrupted_run(runs):
    """B (A's train state resumed on both ranks, to 3 epochs) and C (3
    epochs straight): model.pt bit for bit, the same update count."""
    _, out = runs
    assert "Resumed from" in out["b"]["log"]
    sb = torch.load(os.path.join(out["b"]["results"], "model.pt"))
    sc = torch.load(os.path.join(out["c"]["results"], "model.pt"))
    assert sb.keys() == sc.keys() and all(torch.equal(sb[k], sc[k]) for k in sb)
    from madeleine_torch.train import checkpoint as ckpt

    assert ckpt.restore_train_state(os.path.join(out["b"]["results"], "train_state"))[
        "updates"] == ckpt.restore_train_state(os.path.join(out["c"]["results"],
                                                            "train_state"))["updates"] == 6


def test_a_wrong_mesh_shape_raises_on_every_rank(runs, tmp_path):
    """--mesh_shape 3 at world size 2: both ranks raise the ValueError that
    names both values, and nothing is written."""
    root, _ = runs
    argv = TP._argv(root, str(tmp_path / "results"), 1, "--batch_size", "6",
                    "--mesh_shape", "3")
    rc, log = _torchrun(argv, str(tmp_path / "bad.log"))
    assert rc != 0
    assert log.count("ValueError: --mesh_shape 3 does not match the world size 2") == 2, \
        log[-3000:]
    assert not (tmp_path / "results").exists()
