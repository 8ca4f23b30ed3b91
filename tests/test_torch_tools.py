"""The port's data and trace tools against the JAX package's scripts:
`python -m madeleine_torch.tools.build_dataset_csvs` (the csv module, no
pandas) against `scripts/build_dataset_csvs.py` (pandas) on the same files,
the manifests byte for byte and the same printed lines; and
`python -m madeleine_torch.tools.profile_summary` (a torch.profiler Chrome
trace) against `scripts/profile_summary.py` (a JAX trace) on two hand-written
traces with the same durations, the same printed numbers; the summary also
on a real CPU trace of a train step from `utils.profiling.trace`."""

import gzip
import importlib.util
import json
import os
import re
import sys

import numpy as np
import pytest

from madeleine_torch.tools import build_dataset_csvs as csvs
from madeleine_torch.tools import profile_summary as summary

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    """The JAX package's script `scripts/<name>.py` as a module (its
    ``__main__`` block does not run)."""
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_csvs():
    return _script("build_dataset_csvs")


@pytest.fixture(scope="module")
def jax_summary():
    return _script("profile_summary")


# names: a split suffix (case 03), a missing stain (case 02 lacks PGR and
# ER), .h5 and .npz, and files the pattern skips (a .bag, a stain of another
# dataset, no stain, a csv)
BAG_NAMES = ["case00_HE.h5", "case00_HER2.h5", "case00_PGR.npz", "case00_KI67.h5",
             "case00_ER.h5", "case01_HE.npz", "case01_ER.npz", "case02_HE.h5",
             "case02_HER2.h5", "case02_KI67.h5", "case03_HE_val.h5", "case03_KI67_val.npz",
             "case04_HE.bag", "case04_CD8.h5", "case05.h5", "notes.csv", "s_06_HE_test.npz"]


@pytest.mark.parametrize("dataset", ["ACROBAT", "OTHER"])
def test_scan_features_equals_jax(tmp_path, capsys, jax_csvs, dataset):
    """The manifest of the same file names, byte for byte, and the same
    printed lines (the write and, for ACROBAT, the schema check); another
    dataset's manifest has an H&E column alone and no schema check."""
    feats = tmp_path / "feats"
    feats.mkdir()
    for name in BAG_NAMES:
        (feats / name).write_bytes(b"")
    csvs.scan_features(str(feats), dataset, str(tmp_path / "port" / "out.csv"))
    ours = capsys.readouterr().out.replace(str(tmp_path / "port"), "<dir>")
    jax_csvs.scan_features(str(feats), dataset, str(tmp_path / "jax" / "out.csv"))
    theirs = capsys.readouterr().out.replace(str(tmp_path / "jax"), "<dir>")
    got = (tmp_path / "port" / "out.csv").read_bytes()
    assert got == (tmp_path / "jax" / "out.csv").read_bytes()
    assert ours == theirs
    lines = got.decode().splitlines()
    if dataset == "ACROBAT":
        assert lines[0] == "slide_id,HE,HER2,PGR,KI67,ER,split"
        assert "case02,1,1,0,1,0,train" in lines and "case03,1,0,0,1,0,val" in lines
        assert "s_06,1,0,0,0,0,test" in lines and len(lines) == 6
    else:
        assert lines[0] == "slide_id,HE,split" and len(lines) == 6


def test_scan_features_refuses_an_empty_dir_as_jax(tmp_path, jax_csvs):
    (tmp_path / "a.bag").write_bytes(b"")
    msgs = []
    for scan in (csvs.scan_features, jax_csvs.scan_features):
        with pytest.raises(SystemExit) as e:
            scan(str(tmp_path), "ACROBAT", str(tmp_path / "o.csv"))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "no bag files matching" in msgs[0]


@pytest.mark.parametrize("case", ["repo", "missing_column"])
def test_from_reference_equals_jax(tmp_path, capsys, jax_csvs, case):
    """The repo's own dataset_csv as the reference (ACROBAT and BCNB copied
    and checked), or a reference whose ACROBAT lacks its split column and
    has no BCNB: the same files and lines, or the same exit message."""
    if case == "repo":
        ref = REPO
    else:
        ref = str(tmp_path / "ref")
        os.makedirs(os.path.join(ref, "dataset_csv", "ACROBAT"))
        with open(os.path.join(ref, "dataset_csv", "ACROBAT", "ACROBAT.csv"), "w") as f:
            f.write("slide_id,HE,HER2,PGR,KI67,ER\n1,1,0,1,1,1\n\n2,1,1,1,1,1\n")
    outs, errs = [], []
    for tool, name in ((csvs, "port"), (jax_csvs, "jax")):
        root = str(tmp_path / name)
        try:
            tool.from_reference(ref, root)
            errs.append(None)
        except SystemExit as e:
            errs.append(str(e).replace(root, "<dir>"))
        outs.append(capsys.readouterr().out.replace(root, "<dir>"))
    assert outs[0] == outs[1] and errs[0] == errs[1]
    if case == "repo":
        assert errs[0] is None and outs[0].count("schema OK") == 2
        for ds in ("ACROBAT", "BCNB"):
            got = (tmp_path / "port" / ds / f"{ds}.csv").read_bytes()
            assert got == (tmp_path / "jax" / ds / f"{ds}.csv").read_bytes()
    else:
        assert "missing columns ['split']" in errs[0]


def test_cli_main_writes_under_out_root(tmp_path, capsys):
    """``main`` with the script's flags: --scan_features writes
    <out_root>/<dataset>/<dataset>.csv; neither mode is an error."""
    feats = tmp_path / "feats"
    feats.mkdir()
    for name in BAG_NAMES[:5]:
        (feats / name).write_bytes(b"")
    csvs.main(["--scan_features", str(feats), "--out_root", str(tmp_path / "root")])
    out = (tmp_path / "root" / "ACROBAT" / "ACROBAT.csv").read_text()
    assert out == "slide_id,HE,HER2,PGR,KI67,ER,split\ncase00,1,1,1,1,1,train\n"
    assert "1 rows, schema OK" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        csvs.main([])


# ---------------------------------------------------------------------------
# the trace summary
# ---------------------------------------------------------------------------

# (name, µs) of each device event, in trace order, for 3 steps of one module
OPS = [("fusion_gemm", 1500.25), ("reduce_rows", 310.5), ("fusion_gemm", 1490.75),
       ("copy_start", 42.0), ("softmax_tail", 77.125), ("reduce_rows", 305.0),
       ("fusion_gemm", 1510.0), ("adam_update", 120.5), ("memset_zero", 3.25)]
STEPS = [4200.5, 3800.25, 3790.0]


def _jax_trace(root):
    """A JAX trace (plugins/profile/<run>/<host>.trace.json.gz) of OPS and STEPS."""
    d = os.path.join(root, "plugins", "profile", "2026_01_01")
    os.makedirs(d)
    ev = [{"ph": "M", "pid": 1, "tid": 1, "name": "thread_name", "args": {"name": "XLA Modules"}},
          {"ph": "M", "pid": 1, "tid": 2, "name": "thread_name", "args": {"name": "XLA Ops"}},
          {"ph": "M", "pid": 1, "tid": 3, "name": "thread_name", "args": {"name": "Steps"}}]
    ev += [{"ph": "X", "pid": 1, "tid": 1, "name": f"jit_step_fn({i})", "ts": 1e4 * i,
            "dur": dur} for i, dur in enumerate(STEPS)]
    ev += [{"ph": "X", "pid": 1, "tid": 2, "name": n, "ts": 100 * i, "dur": dur,
            "args": {"long_name": f"%{n} = ..."}} for i, (n, dur) in enumerate(OPS)]
    ev += [{"ph": "X", "pid": 1, "tid": 3, "name": "step", "ts": 0, "dur": 9e9}]
    with gzip.open(os.path.join(d, "host.trace.json.gz"), "wt") as f:
        json.dump({"traceEvents": ev}, f)


def _torch_trace(root):
    """A torch.profiler Chrome trace (trace.json) of the same OPS and STEPS,
    the ranges listed out of time order, with host events beside them."""
    cats = {"copy_start": "gpu_memcpy", "memset_zero": "gpu_memset"}
    ev = [{"ph": "X", "cat": "gpu_user_annotation", "name": "step_fn", "ts": 1e4 * i,
           "dur": dur, "pid": 0, "tid": 7} for i, dur in reversed(list(enumerate(STEPS)))]
    ev += [{"ph": "X", "cat": "user_annotation", "name": "step_fn", "ts": 1e4 * i, "dur": 9e9,
            "pid": 1, "tid": 1} for i in range(3)]
    ev += [{"ph": "X", "cat": cats.get(n, "kernel"), "name": n, "ts": 100 * i, "dur": dur,
            "pid": 0, "tid": 7} for i, (n, dur) in enumerate(OPS)]
    ev += [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 5, "dur": 9e9, "pid": 1,
            "tid": 1}, {"ph": "i", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 0}]
    os.makedirs(root)
    with open(os.path.join(root, "trace.json"), "w") as f:
        json.dump({"traceEvents": ev}, f)


def _numbers(text):
    """The summary's numbers, line by line (the op lines' ms and share)."""
    out = []
    for line in text.strip().splitlines():
        if not line.strip():
            continue
        head = line.split(":")[-1] if not line.lstrip()[0].isdigit() else line[:24]
        out.append(re.findall(r"\d+\.\d+|\d+", head))
    return out


@pytest.mark.parametrize("top", [3, 20])
def test_summary_equals_jax_on_the_same_durations(tmp_path, capsys, monkeypatch, jax_summary,
                                                   top):
    """The module's ms a step and the steps captured, the total ms a step and
    the distinct ops, each top op's ms a step and share: the same numbers
    from both scripts; the op names too, in the same order."""
    _jax_trace(str(tmp_path / "jax"))
    _torch_trace(str(tmp_path / "port"))
    monkeypatch.setattr(sys, "argv", ["profile_summary.py", str(tmp_path / "jax"),
                                      "--top", str(top)])
    jax_summary.main()
    theirs = capsys.readouterr().out
    summary.main([str(tmp_path / "port"), "--top", str(top)])
    ours = capsys.readouterr().out
    assert _numbers(ours) == _numbers(theirs)
    assert len(_numbers(ours)) == 2 + min(top, 6)
    assert ours.splitlines()[0] == theirs.splitlines()[0] == \
        "step_fn device time: 4.2 ms/step  (3 steps captured)"
    names = [ln.split()[3] for ln in ours.splitlines()[3:]]
    assert names == [ln.split()[3] for ln in theirs.splitlines()[3:]]
    assert names[0] == "fusion_gemm"


def test_summary_without_a_trace_exits_as_jax(tmp_path, monkeypatch, jax_summary):
    monkeypatch.setattr(sys, "argv", ["profile_summary.py", str(tmp_path)])
    with pytest.raises(SystemExit, match="no .*trace.json.gz under"):
        jax_summary.main()
    with pytest.raises(SystemExit, match="no trace.json under"):
        summary.main([str(tmp_path)])


def test_summary_of_a_real_cpu_trace_of_train_steps(tmp_path, capsys):
    """Two CPU train steps (f32, InfoNCE) under `utils.profiling.trace`:
    their two ``step_fn`` ranges, host ops summed under the CPU heading, the
    matrix products among them."""
    from madeleine_torch.setup import setup_model
    from madeleine_torch.train.optim import make_optimizer
    from madeleine_torch.train.trainer import make_train_step
    from madeleine_torch.utils.profiling import trace
    from tests.torch_port_helpers import configs, train_batch

    _, cfg = configs(local_loss="-1", temperature=0.001, warmup=False, max_epochs=3)
    model = setup_model(cfg, seed=0, device="cpu")
    opt, sched = make_optimizer(cfg, model.parameters(), steps_per_epoch=10)
    step = make_train_step(cfg, model, opt, sched)
    batch = train_batch(np.random.default_rng(0), bs=4, n_mod=3, t=8, d=64)
    with trace(str(tmp_path / "prof" / "run")):
        for seed in range(2):
            step(batch, seed=seed)
    assert int(step.updates) == 2
    summary.main([str(tmp_path / "prof"), "--top", "40"])
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert re.fullmatch(r"step_fn host time: \d+\.\d ms/step  \(2 steps captured\)", lines[0])
    assert lines[1].startswith("total CPU op time (no CUDA activity")
    assert "aten::addmm" in out or "aten::mm" in out
    agg = summary.aggregate(json.load(open(tmp_path / "prof" / "run" / "trace.json"))
                            ["traceEvents"])
    assert not agg["device"] and agg["steps"] == 2 and len(agg["ranges"]) == 2
