"""The port's native .bag path on the CPU (g++ builds the host library
``madeleine_torch/csrc/bagio.cpp``), held against the JAX package's
(`madeleine_tpu.native`) bit for bit and against its own plain versions:
the subsample draw, the writer, the batch assembler, `NativeTrainLoader`
over two epochs, the ring under a prefetch thread, the host build's lock,
and `python -m madeleine_torch.cli.convert_bags`.

bf16 batches are compared as 16-bit patterns: the JAX package's are
ml_dtypes arrays, the port's torch bf16 tensors."""

import csv
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from madeleine_tpu.native import bagio as JB
from madeleine_tpu.native import dataset as JN
from madeleine_torch.cli import convert_bags
from madeleine_torch.config import MODALITY_DICTS
from madeleine_torch.data.datasets import Prefetcher
from madeleine_torch.native import bagio as B
from madeleine_torch.native.dataset import NativeRaggedLoader, NativeTrainLoader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAINS = MODALITY_DICTS["ACROBAT"]


@pytest.fixture(scope="module", autouse=True)
def jax_native_lib(tmp_path_factory):
    """The JAX package's library, built into this module's own temp dir
    when this process has not loaded it yet: its build writes straight to
    its output, which another test process may be building too."""
    if JB._lib is not None:
        yield JB._lib
        return
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "_SO", str(tmp_path_factory.mktemp("jax_bagio") / "libbagio.so"))
        lib = JB.get_lib()
        assert lib is not None, "the JAX package's native library did not build"
        yield lib


def _with_ties(x):
    """x (f32) with the low 16 bits of its first 8 columns set to 0x8000: the
    ties of bf16 rounding, which a random float almost never hits."""
    u = x.view(np.uint32)
    u[:, :8] = (u[:, :8] & 0xFFFF0000) | 0x8000
    return x


def _bits(x):
    """A batch as comparable numpy: f32 values, or bf16 as uint16 patterns."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return (x.view(torch.int16).numpy().view(np.uint16) if x.dtype == torch.bfloat16
                else x.numpy().copy())
    return x.view(np.uint16).copy() if x.dtype.itemsize == 2 else np.array(x)


# ---------------------------------------------------------------------------
# the draw, the writer, the assembler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7919, 2 ** 63 - 25, 0x5DEECE66D * 977])
def test_sample_indices_equal_jax_and_plain(seed):
    """n = 0 (zeros), n < t (with replacement), n = t, n > t (selection
    sampling): the library, the JAX package's library and the pure-Python
    draw agree bit for bit; the rows come back sorted and in range."""
    t = 24
    n_rows = np.array([0, 1, 5, 23, 24, 25, 60, 1000, 0, 24], np.int64)
    got = B.sample_indices(seed, n_rows, t)
    assert got.shape == (len(n_rows), t) and got.dtype == np.int64
    assert np.array_equal(got, JB.sample_indices(seed, n_rows, t))
    assert np.array_equal(got, B.sample_indices_plain(seed, n_rows, t))
    for row, n in zip(got, n_rows):
        assert (np.diff(row) >= 0).all()
        assert (row == 0).all() if n == 0 else (row >= 0).all() and (row < n).all()
        if n >= t:
            assert len(set(row.tolist())) == t     # without replacement
    assert not np.array_equal(got, B.sample_indices(seed + 1, n_rows, t))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_coords", [False, True], ids=["no_coords", "coords"])
def test_write_bag_file_bytes_equal_jax(tmp_path, dtype, with_coords):
    rng = np.random.default_rng(1)
    feats = _with_ties(rng.standard_normal((37, 24)).astype(np.float32))
    feats[0, :4] = [np.inf, -0.0, 1e-40, 3.3895314e38]   # inf, signed zero, subnormal, near max
    coords = rng.integers(0, 10 ** 6, (37, 2)) if with_coords else None
    B.write_bag_file(str(tmp_path / "port.bag"), feats, coords, dtype=dtype)
    JB.write_bag_file(str(tmp_path / "jax.bag"), feats, coords, dtype=dtype)
    assert (tmp_path / "port.bag").read_bytes() == (tmp_path / "jax.bag").read_bytes()
    r = B.BagReader(str(tmp_path / "port.bag"))
    assert (r.n_rows, r.n_cols) == (37, 24)
    idx = np.array([3, 0, 36, 37, -1, 3])
    stored = JB._read_bag_numpy(str(tmp_path / "jax.bag"))[0]
    got = r.gather(idx)
    assert np.array_equal(got[[0, 1, 2, 5]], stored[[3, 0, 36, 3]])
    assert not got[3:5].any()                       # rows out of range
    r.close()


@pytest.mark.parametrize("disk", ["float32", "bfloat16"])
@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_assemble_batch_equals_plain_and_jax(tmp_path, disk, out):
    """Tasks from two bags, a null handle (an absent stain: zeros) and rows
    out of range (zeros), runs of consecutive rows (the merged streaming
    copy) and repeats: equal to the plain version and to the JAX package's
    assembler bit for bit."""
    rng = np.random.default_rng(2)
    paths = []
    for i, n in enumerate((50, 9)):
        paths.append(str(tmp_path / f"b{i}.bag"))
        B.write_bag_file(paths[-1], _with_ties(rng.standard_normal((n, 40)).astype(np.float32)),
                         dtype=disk)
    t = 20
    idx = np.stack([np.arange(t), np.r_[0:8, 8, 8, 9, 50, -1, 3, 4, 5, 6, 100, 2, 1],
                    np.zeros(t, np.int64), np.sort(rng.integers(0, 50, t))]).astype(np.int64)
    readers = [B.BagReader(paths[0]), B.BagReader(paths[1]), None, B.BagReader(paths[0])]
    buf = torch.full((4, t, 40), 7.0, dtype=out)     # stale contents must not survive
    got = B.assemble_batch(readers, idx, 40, buf, n_threads=3)
    assert got is buf
    plain = B.assemble_batch_plain([None if r is None else B.PlainBag(r.path) for r in readers],
                                   idx, 40, out)
    assert np.array_equal(_bits(got), _bits(plain))
    assert not _bits(got)[2].any() and not _bits(got)[1, 11:13].any()
    jr = [None if r is None else JB.BagReader(r.path) for r in readers]
    want = JB.assemble_batch(jr, idx, 40, n_threads=3,
                             dtype="bfloat16" if out == torch.bfloat16 else "float32")
    assert np.array_equal(_bits(got), _bits(want))
    with pytest.raises(ValueError, match="contiguous"):
        B.assemble_batch(readers, idx, 40, torch.empty(4, t, 40, dtype=torch.float16))
    with pytest.raises(ValueError, match="columns"):
        B.assemble_batch(readers, idx, 39, torch.empty(4, t, 39))


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------

def _write_bag_cohort(root, n_cases, d, lengths=(10, 60), disk="float32", seed=0,
                      empty_bag=False, absent=True):
    """<root>/bags/{case}_{stain}.bag (HE always present, the other stains
    missing at random), <root>/cohort.csv with explicit ``train`` splits and
    non-numeric ids; optionally one present bag of 0 rows, and one bag the
    CSV lists that is absent on disk."""
    rng = np.random.default_rng(seed)
    bags = os.path.join(root, "bags")
    os.makedirs(bags)
    rows, listed = [], []
    for i in range(n_cases):
        labels = {s: int(s == "HE" or rng.random() < 0.7) for s in STAINS}
        for s, present in labels.items():
            if present:
                n = 0 if (empty_bag and i == 2 and s == "HE") else int(rng.integers(*lengths))
                path = os.path.join(bags, f"case{i}_{s}.bag")
                B.write_bag_file(path, _with_ties(rng.standard_normal((n, d)).astype(np.float32)),
                                 dtype=disk)
                listed.append(path)
        rows.append({"slide_id": f"case{i}", **labels, "split": "train"})
    if absent:
        os.remove(listed[len(listed) // 2])
    csv_path = os.path.join(root, "cohort.csv")
    with open(csv_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    return csv_path, bags


def _snapshot(batch):
    return {"feats": _bits(batch["feats"]), "modality_labels": np.array(batch["modality_labels"]),
            "sample_mask": np.array(batch["sample_mask"]),
            "slide_ids": [str(s) for s in batch["slide_ids"]]}


LOADER_CASES = {"f32": ("float32", "float32"), "bf16_from_f32": ("bfloat16", "float32"),
                "bf16_from_bf16": ("bfloat16", "bfloat16")}


@pytest.mark.parametrize("per_case_seed", [False, True], ids=["batch_seed", "per_case_seed"])
@pytest.mark.parametrize("case", list(LOADER_CASES))
def test_native_train_loader_equals_jax(tmp_path, case, per_case_seed, capsys):
    """11 cases in batches of 4 (the last padded by one masked row), 24
    tokens from bags of 10-59 rows (short bags drawn with replacement),
    missing stains and a CSV-listed bag absent on disk (with the JAX
    package's warning), and without per_case_seed a present bag of 0 rows:
    feats, modality_labels, sample_mask and slide_ids equal the JAX
    package's NativeTrainLoader bit for bit in epochs 0 and 1, and the
    plain route's (pure-Python draw, numpy gather) too."""
    out_dtype, disk = LOADER_CASES[case]
    csv_path, bags = _write_bag_cohort(str(tmp_path), 11, 16, disk=disk,
                                       empty_bag=not per_case_seed)
    kw = dict(embedding_size=16, sample=24, batch_size=4, seed=5, per_case_seed=per_case_seed,
              out_dtype=out_dtype)
    ours = NativeTrainLoader(csv_path, bags, STAINS, device="cpu", **kw)
    plain = NativeTrainLoader(csv_path, bags, STAINS, device="cpu", plain=True, **kw)
    theirs = JN.NativeTrainLoader(csv_path, bags, STAINS, **kw)
    assert capsys.readouterr().out.count("1 (case, stain) bags listed in the csv are missing") == 3
    assert len(ours) == len(theirs) == 3
    for epoch in (0, 1):
        for loader in (ours, plain, theirs):
            loader.set_epoch(epoch)
        got = [_snapshot(b) for b in ours]
        assert len(ours.timings) == 3 and all(v >= 0 for t in ours.timings for v in t.values())
        for g, p, w in zip(got, map(_snapshot, plain), map(_snapshot, theirs)):
            assert g["feats"].shape == (4, 5, 24, 16)
            for key in ("feats", "modality_labels", "sample_mask"):
                assert np.array_equal(g[key], w[key]), (epoch, key)
                assert np.array_equal(g[key], p[key]), (epoch, key, "plain")
            assert g["slide_ids"] == w["slide_ids"] == p["slide_ids"]
        assert got[-1]["sample_mask"].tolist() == [True, True, True, False]
        assert not got[-1]["modality_labels"][3].any()
        assert got[-1]["slide_ids"][3] == got[-1]["slide_ids"][0]   # padding repeats sel[:1]
        assert any((g["modality_labels"] == 0).any() for g in got)
    first = [_snapshot(b)["feats"] for b in ours]
    ours.set_epoch(0)
    assert not all(np.array_equal(a, _snapshot(b)["feats"]) for a, b in zip(first, ours))
    for loader in (ours, theirs):
        loader.close()


def _ragged_snapshot(batch):
    return dict(_snapshot(batch), token_mask=np.array(batch["token_mask"]))


@pytest.mark.parametrize("max_tokens", [None, 40], ids=["whole", "capped"])
@pytest.mark.parametrize("case", list(LOADER_CASES))
def test_native_ragged_loader_equals_jax(tmp_path, case, max_tokens, capsys):
    """Full bags of 10-59 rows, missing stains, a CSV-listed bag absent on
    disk and a present bag of 0 rows (all-masked bags), 11 cases in batches
    of 4 (the last padded, masked, its ids the valid cases'), buckets (16,
    32): the longest bags grow the bucket to 64, or are capped at 40 (every
    capped bag of the batch counted, rows past 40 unmasked); feats, token_mask,
    modality_labels, sample_mask and slide_ids equal the JAX package's
    NativeRaggedLoader bit for bit in epochs 0 and 1, and the plain
    route's, as does the truncation count; every ring slot is sized once
    for the cohort's largest bucket and never replaced (pinned_bytes is 0 on
    the CPU)."""
    out_dtype, disk = LOADER_CASES[case]
    csv_path, bags = _write_bag_cohort(str(tmp_path), 11, 16, disk=disk, empty_bag=True)
    kw = dict(embedding_size=16, batch_size=4, seed=5, out_dtype=out_dtype,
              buckets=(16, 32), max_tokens=max_tokens)
    ours = NativeRaggedLoader(csv_path, bags, STAINS, device="cpu", **kw)
    plain = NativeRaggedLoader(csv_path, bags, STAINS, device="cpu", plain=True, **kw)
    theirs = JN.NativeRaggedLoader(csv_path, bags, STAINS, **kw)
    assert capsys.readouterr().out.count("1 (case, stain) bags listed in the csv are missing") == 3
    buckets, slots = set(), [x.data_ptr() for x in ours._ring]
    for epoch in (0, 1):
        for loader in (ours, plain, theirs):
            loader.set_epoch(epoch)
        got = [_ragged_snapshot(b) for b in ours]
        assert len(got) == 3 and len(ours.timings) == 3
        for g, p, w in zip(got, map(_ragged_snapshot, plain), map(_ragged_snapshot, theirs)):
            for key in ("feats", "token_mask", "modality_labels", "sample_mask"):
                assert np.array_equal(g[key], w[key]), (epoch, key)
                assert np.array_equal(g[key], p[key]), (epoch, key, "plain")
            assert g["slide_ids"] == w["slide_ids"] == p["slide_ids"]
            assert not g["feats"][~g["token_mask"]].any() or max_tokens is not None
            buckets.add(g["feats"].shape[2])
        assert got[-1]["sample_mask"].tolist() == [True, True, True, False]
        assert len(got[-1]["slide_ids"]) == 3 and not got[-1]["modality_labels"][3].any()
    assert buckets == {64} and ours.pinned_bytes == 0
    assert ours.truncation_count == theirs.truncation_count
    assert (ours.truncation_count > 0) == (max_tokens is not None)
    assert [x.numel() for x in ours._ring] == [4 * 5 * 64 * 16] * len(slots)
    assert [x.data_ptr() for x in ours._ring] == slots
    for loader in (ours, theirs):
        loader.close()


def test_native_loader_ring_survives_a_prefetcher(tmp_path):
    """Nine batches through a Prefetcher of depth 2 over a ring of 4 slots,
    each held until the next arrives: every batch equals the copy taken when
    it was made."""
    csv_path, bags = _write_bag_cohort(str(tmp_path), 34, 8, absent=False)
    loader = NativeTrainLoader(csv_path, bags, STAINS, embedding_size=8, sample=16,
                               batch_size=4, seed=1, buffer_depth=4, device="cpu")
    made = []

    def recorded():
        for b in loader:
            made.append(_bits(b["feats"]))
            yield b

    held = []
    for b in Prefetcher(recorded(), depth=2):
        held.append(b)
        if len(held) > 1:
            prev = held[-2]
            assert np.array_equal(_bits(prev["feats"]), made[len(held) - 2])
        assert np.array_equal(_bits(b["feats"]), made[len(held) - 1])
    assert len(held) == len(made) == 9
    assert not np.array_equal(made[0], made[4])


def test_native_loader_refuses_what_is_not_ported(tmp_path):
    """Several processes (A7, data parallelism) run: at process_count 2 each
    rank's batches of the subsampling loader (per_case_seed) and of the
    ragged one are the JAX package's local rows bit for bit, 2 of each
    global batch of 4 (rank 1's last row padding), and the ring's slots
    hold 2 rows; the ragged bucket is the global batch's, the same on both
    ranks. A subsampling loader without per_case_seed under several
    processes, an odd split and sample -1 raise (full bags are the ragged
    loader's)."""
    csv_path, bags = _write_bag_cohort(str(tmp_path), 7, 8, absent=False)
    buckets = {0: [], 1: []}
    for rank in (0, 1):
        kw = dict(embedding_size=8, batch_size=4, seed=2, process_index=rank, process_count=2)
        pairs = [(NativeTrainLoader(csv_path, bags, STAINS, sample=6, per_case_seed=True,
                                    device="cpu", **kw),
                  JN.NativeTrainLoader(csv_path, bags, STAINS, sample=6, per_case_seed=True,
                                       **kw), _snapshot, 6),
                 (NativeRaggedLoader(csv_path, bags, STAINS, buckets=(16, 32), device="cpu",
                                     **kw),
                  JN.NativeRaggedLoader(csv_path, bags, STAINS, buckets=(16, 32), **kw),
                  _ragged_snapshot, 64)]
        for ours, theirs, snap, slot_t in pairs:
            assert all(x.numel() == 2 * 5 * slot_t * 8 for x in ours._ring)
            for epoch in (0, 1):
                ours.set_epoch(epoch)
                theirs.set_epoch(epoch)
                got, want = [snap(b) for b in ours], [snap(b) for b in theirs]
                assert len(got) == len(want) == 2
                for g, w in zip(got, want):
                    assert g["feats"].shape[0] == 2 and g["slide_ids"] == w["slide_ids"]
                    for key in set(g) - {"slide_ids"}:
                        assert np.array_equal(g[key], w[key]), (rank, epoch, key)
                assert got[-1]["sample_mask"].tolist() == [True, rank == 0]
                if snap is _ragged_snapshot:
                    buckets[rank] += [g["feats"].shape[2] for g in got]
            ours.close()
            theirs.close()
    assert buckets[0] == buckets[1]
    args = dict(embedding_size=8, batch_size=2, device="cpu")
    with pytest.raises(ValueError, match="per_case_seed"):
        NativeTrainLoader(csv_path, bags, STAINS, sample=4, process_count=2, **args)
    with pytest.raises(ValueError, match="not divisible"):
        NativeRaggedLoader(csv_path, bags, STAINS, process_count=3, **args)
    with pytest.raises(ValueError, match="NativeRaggedLoader"):
        NativeTrainLoader(csv_path, bags, STAINS, sample=-1, **args)
    batch = next(iter(NativeRaggedLoader(csv_path, bags, STAINS, buckets=(64,), **args)))
    assert batch["feats"].shape == (2, 5, 64, 8) and batch["token_mask"].shape == (2, 5, 64)
    assert batch["token_mask"].any()


# ---------------------------------------------------------------------------
# the build, the converter
# ---------------------------------------------------------------------------

def test_host_build_is_shared_by_concurrent_processes(tmp_path):
    """Three processes build the library into one empty build dir at once:
    the file lock lets one compile and the others load its result; each
    draws the same indices, and no temporary file is left."""
    code = ("import sys, numpy as np\n"
            "from madeleine_torch.ops import _build\n"
            "_build.BUILD_DIR = sys.argv[1]\n"
            "from madeleine_torch.native import bagio\n"
            "print(bagio.sample_indices(3, np.array([5, 40]), 8).sum())\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=REPO,
                              env=dict(os.environ, PYTHONPATH=REPO), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(3)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1][-2000:] for o in outs]
    want = str(B.sample_indices(3, np.array([5, 40]), 8).sum())
    assert [o[0].strip() for o in outs] == [want] * 3
    assert sorted(os.listdir(tmp_path)) == ["libbagio.so", "libbagio.so.lock"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_bags_equals_jax(tmp_path, dtype):
    """`python -m madeleine_torch.cli.convert_bags` over .npz bags with and
    without coords writes the bytes of the JAX package's convert_to_bag."""
    rng = np.random.default_rng(4)
    src = tmp_path / "src"
    src.mkdir()
    np.savez(src / "a.npz", features=rng.standard_normal((30, 12)).astype(np.float32),
             coords=rng.integers(0, 5000, (30, 2)))
    np.savez(src / "b.npz", features=rng.standard_normal((1, 7, 12)).astype(np.float32))
    dst = convert_bags.main(["--src", str(src), "--dst", str(tmp_path / "port"),
                             "--dtype", dtype])
    assert sorted(os.listdir(dst)) == ["a.bag", "b.bag"]
    for name in ("a", "b"):
        want = JB.convert_to_bag(str(src / f"{name}.npz"), str(tmp_path / f"jax_{name}.bag"),
                                 dtype=dtype)
        assert open(os.path.join(dst, f"{name}.bag"), "rb").read() == open(want, "rb").read()
    r = B.BagReader(os.path.join(dst, "b.bag"))
    assert (r.n_rows, r.n_cols) == (7, 12)
    r.close()
