"""The port's pretraining path on the CPU: the multistain dataset and loader
against the JAX package's (bit for bit), the crash-safe train-state
checkpoints, and `python -m madeleine_torch.cli.pretrain` run in-process
(`main([... "--device", "cpu"])`): its artifacts, its model.pt loading into
both packages, and an exact resume."""

import csv
import json
import os
import pickle

import numpy as np
import pytest
import torch

from madeleine_tpu.data import datasets as JD
from madeleine_tpu.models.factory import load_torch_state_dict as jax_load_torch_state_dict
from madeleine_tpu.models.factory import state_dict_to_params
from madeleine_torch.cli import pretrain
from madeleine_torch.config import MODALITY_DICTS, MadeleineConfig
from madeleine_torch.data import datasets as D
from madeleine_torch.models.factory import create_model
from madeleine_torch.train import checkpoint as ckpt

STAINS = MODALITY_DICTS["ACROBAT"]


def _write_cohort(root, n_cases, d, lengths=(10, 60), seed=0, n_down=4):
    """<root>/feats/{case}_{stain}.npz bags (HE and KI67 always present, the
    other stains missing at random), <root>/ACROBAT.csv, and n_down
    downstream bags in <root>/downstream/patch_embeddings."""
    rng = np.random.default_rng(seed)
    feats = os.path.join(root, "feats")
    os.makedirs(feats)
    rows = []
    for i in range(n_cases):
        labels = {s: int(s in ("HE", "KI67") or rng.random() < 0.75) for s in STAINS}
        for s, present in labels.items():
            if present:
                n = int(rng.integers(*lengths))
                np.savez(os.path.join(feats, f"case{i}_{s}.npz"),
                         features=rng.standard_normal((n, d)).astype(np.float32))
        rows.append({"slide_id": f"case{i}", **labels, "split": "train"})
    csv_path = os.path.join(root, "ACROBAT.csv")
    with open(csv_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    down = os.path.join(root, "downstream", "patch_embeddings")
    os.makedirs(down)
    for i in range(n_down):
        np.savez(os.path.join(down, f"d{i}.npz"),
                 features=rng.standard_normal((int(rng.integers(30, 90)), d)).astype(np.float32))
    return csv_path, feats, os.path.dirname(down)


# ---------------------------------------------------------------------------
# dataset and loader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("per_case_seed", [False, True])
def test_train_loader_batches_equal_jax(tmp_path, per_case_seed):
    """11 cases, batch 4 (the last batch padded by one masked row), 24 tokens
    drawn from bags of 10-59 (short bags drawn with replacement), missing
    stains: feats, modality_labels, sample_mask and slide_ids equal the JAX
    package's bit for bit, in epochs 0 and 1."""
    csv_path, feats, _ = _write_cohort(str(tmp_path), 11, 16)
    kw = dict(embedding_size=16, sample=24, per_case_seed=per_case_seed, seed=3)
    ours = D.TrainLoader(D.SlideDataset("ACROBAT", csv_path, feats, STAINS, **kw), 4, seed=3)
    theirs = JD.TrainLoader(JD.SlideDataset("ACROBAT", csv_path, feats, STAINS,
                                            rng=np.random.default_rng(3), **kw), 4, seed=3)
    assert len(ours) == len(theirs) == 3
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g["feats"].dtype == w["feats"].dtype == np.float32
            assert g["feats"].shape == (4, 5, 24, 16)
            for key in ("feats", "modality_labels", "sample_mask"):
                assert np.array_equal(g[key], w[key]), (epoch, key)
            assert g["slide_ids"] == list(w["slide_ids"])
        assert got[-1]["sample_mask"].tolist() == [True, True, True, False]
        assert not got[-1]["modality_labels"][3].any()
        assert (got[0]["modality_labels"] == 0).any()    # a missing stain in the batch


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _state(seed):
    g = torch.Generator().manual_seed(seed)
    return {"model": {"w": torch.randn(3, 4, generator=g)},
            "optimizer": {"state": {0: {"exp_avg": torch.randn(3, 4, generator=g),
                                        "step": torch.tensor(7.0)}}},
            "updates": 7}


def test_train_state_round_trip_and_crash_fallback(tmp_path):
    """A save restores equal; a second save replaces it and leaves no .tmp
    or .old; after a crash that left the new checkpoint half written and
    the previous one parked at .old, restore falls back to .old."""
    d = str(tmp_path / "train_state")
    ckpt.save_train_state(d, _state(0), metadata={"epoch": 3, "best_rank": 1.5})
    got = ckpt.restore_train_state(d)
    assert torch.equal(got["model"]["w"], _state(0)["model"]["w"]) and got["updates"] == 7
    assert ckpt.load_metadata(d) == {"epoch": 3, "best_rank": 1.5}
    assert ckpt.load_metadata(str(tmp_path / "nothing")) is None
    ckpt.save_train_state(d, _state(1), metadata={"epoch": 4, "best_rank": 2.0})
    assert torch.equal(ckpt.restore_train_state(d)["model"]["w"], _state(1)["model"]["w"])
    assert sorted(os.listdir(tmp_path)) == ["train_state", "train_state.meta.json"]
    # the crash: the previous checkpoint renamed to .old, the new one truncated
    os.rename(d, d + ".old")
    os.makedirs(d)
    with open(os.path.join(d, ckpt.STATE_FILE), "wb") as f:
        f.write(b"\x80\x02truncated")
    got = ckpt.restore_train_state(d)
    assert torch.equal(got["model"]["w"], _state(1)["model"]["w"])
    os.rename(d + ".old", str(tmp_path / "elsewhere"))
    with pytest.raises(Exception):
        ckpt.restore_train_state(d)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _argv(root, results, max_epochs, *extra):
    return ["--dataset", "ACROBAT", "--csv_fpath", os.path.join(root, "ACROBAT.csv"),
            "--data_root_dir", os.path.join(root, "feats"), "--results_dir", results,
            "--patch_embedding_dim", "16", "--wsi_encoder_hidden_dim", "16", "--n_heads", "2",
            "--batch_size", "6", "--n_subsamples", "32", "--max_epochs", str(max_epochs),
            "--warmup", "--warmup_epochs", "1", "--global_loss", "info-nce",
            "--local_loss", "got", "--temperature", "0.01", "--symmetric_cl",
            "--precision", "float32", "--checkpoint_every", "1", "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def two_epochs(tmp_path_factory):
    """(cohort root, results dir) of one 2-epoch run with --checkpoint_every 1
    and --downstream_dir, on 11 cases (2 steps per epoch, the second padded)."""
    root = str(tmp_path_factory.mktemp("cohort"))
    _, _, down = _write_cohort(root, 11, 16, lengths=(20, 60))
    run = pretrain.main(_argv(root, os.path.join(root, "results_a"), 2, "--downstream_dir", down))
    return root, run


def test_pretrain_cli_writes_the_artifacts(two_epochs):
    """The JAX CLI's artifact set (tests/test_pretrain_cli.py) with the port's
    train_state; model.pt loads strictly into the port and, through its
    torch bridge, into the JAX package; one metrics record per epoch."""
    _, run = two_epochs
    names = set(os.listdir(run))
    assert {"config.json", "model_config.txt", "model.pt", "model_config.json",
            "downstream.pkl", "train_state", "train_state.meta.json"} <= names
    cfg = json.load(open(os.path.join(run, "config.json")))
    assert cfg["MODALITIES"][0] == "HE" and cfg["max_epochs"] == 2 and cfg["remat"] is True
    assert ckpt.load_metadata(os.path.join(run, "train_state"))["epoch"] == 1
    res = pickle.load(open(os.path.join(run, "downstream.pkl"), "rb"))
    assert set(res) == {"embeds", "slide_ids"} and res["embeds"].shape == (4, 16)
    assert sorted(res["slide_ids"]) == [f"d{i}" for i in range(4)]
    mcfg = MadeleineConfig.from_json(os.path.join(run, "model_config.json"))
    _, model = create_model(mcfg, checkpoint_path=os.path.join(run, "model.pt"), device="cpu")
    assert sum(p.numel() for p in model.parameters()) > 0
    params = state_dict_to_params(jax_load_torch_state_dict(os.path.join(run, "model.pt")))
    assert "wsi_embedders" in params
    records = [json.loads(line) for line in open(os.path.join(run, "metrics.jsonl"))]
    epochs = [r for r in records if "steps" in r]
    assert [r["epoch"] for r in epochs] == [0, 1]
    for r in epochs:
        assert r["n_steps"] == 2 and r["n_skipped"] == 0 and len(r["loader_ms"]) == 2
        assert all(np.isfinite(s["loss"]) for s in r["steps"])
    assert "Total number of parameters" in open(os.path.join(run, "model_config.txt")).read()


def test_pretrain_cli_resume_equals_an_uninterrupted_run(two_epochs):
    """The 2-epoch run resumed to 3 epochs gives the same final parameters,
    AdamW state and update count as 3 epochs straight (profiled with
    --profile_dir, which writes a chrome trace), bit for bit."""
    root, run_a = two_epochs
    run_b = pretrain.main(_argv(root, os.path.join(root, "results_b"), 3,
                                "--resume", os.path.join(run_a, "train_state")))
    trace_dir = os.path.join(root, "trace")
    run_c = pretrain.main(_argv(root, os.path.join(root, "results_c"), 3,
                                "--profile_dir", trace_dir))
    assert os.path.getsize(os.path.join(trace_dir, "trace.json")) > 0
    sb = torch.load(os.path.join(run_b, "model.pt"))
    sc = torch.load(os.path.join(run_c, "model.pt"))
    assert sb.keys() == sc.keys() and all(torch.equal(sb[k], sc[k]) for k in sb)
    tb = ckpt.restore_train_state(os.path.join(run_b, "train_state"))
    tc = ckpt.restore_train_state(os.path.join(run_c, "train_state"))
    assert tb["updates"] == tc["updates"] == 6
    ob, oc = tb["optimizer"]["state"], tc["optimizer"]["state"]
    assert ob.keys() == oc.keys()
    for i in ob:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(ob[i][k], oc[i][k]), (i, k)
    assert not all(torch.equal(sb[k], torch.load(os.path.join(run_a, "model.pt"))[k])
                   for k in sb)


@pytest.mark.parametrize("flags,item", [(("--n_subsamples", "-1"), "A6"),
                                        (("--mesh_shape", "2"), "A7"),
                                        (("--native_loader", "on"), "A5")])
def test_pretrain_cli_refuses_what_is_not_ported(tmp_path, flags, item):
    argv = _argv(str(tmp_path), str(tmp_path / "results"), 1)
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        pretrain.main(argv + list(flags))
    assert not (tmp_path / "results").exists()


def test_log_ml_without_wandb_is_a_clear_error(tmp_path, monkeypatch):
    import sys

    from madeleine_torch.utils.logging import MetricsLogger

    monkeypatch.setitem(sys.modules, "wandb", None)
    with pytest.raises(RuntimeError, match="wandb"):
        MetricsLogger(str(tmp_path), use_wandb=True)
