"""The Python train loaders under data parallelism, in-process (they take
``process_index``/``process_count``; no process group is needed): each
rank's batches equal the JAX package's local batches bit for bit, and the
ranks' rows make up the single-process batch; the ragged ranks agree on
the global batch's bucket. The native loaders' counterpart is
tests/test_torch_native_loader.py::test_native_loader_refuses_what_is_not_ported."""

import numpy as np
import pytest

from madeleine_tpu.data import datasets as JD
from madeleine_torch.config import MODALITY_DICTS
from madeleine_torch.data import datasets as D
from tests import test_torch_pretrain as TP
from tests import test_torch_ragged as TR

STAINS = MODALITY_DICTS["ACROBAT"]
KEYS = ("feats", "modality_labels", "sample_mask")


def _epochs(loader, epochs=(0, 1)):
    out = []
    for epoch in epochs:
        loader.set_epoch(epoch)
        out.append(list(loader))
    return out


@pytest.mark.parametrize("rank", [0, 1])
def test_train_loader_local_rows_equal_jax(tmp_path, rank):
    """11 cases, a global batch of 6 (the last padded by one masked row)
    over 2 processes, 24 tokens drawn per case (per_case_seed): rank
    `rank`'s batches equal the JAX package's TrainLoader's at that rank bit
    for bit in epochs 0 and 1, and its rows are the single-process batch's."""
    csv_path, feats, _ = TP._write_cohort(str(tmp_path), 11, 16)
    kw = dict(embedding_size=16, sample=24, per_case_seed=True, seed=3)
    ours = D.TrainLoader(D.SlideDataset("ACROBAT", csv_path, feats, STAINS, **kw), 6, seed=3,
                         process_index=rank, process_count=2)
    theirs = JD.TrainLoader(JD.SlideDataset("ACROBAT", csv_path, feats, STAINS,
                                            rng=np.random.default_rng(3), **kw), 6, seed=3,
                            process_index=rank, process_count=2)
    whole = D.TrainLoader(D.SlideDataset("ACROBAT", csv_path, feats, STAINS, **kw), 6, seed=3)
    assert len(ours) == len(theirs) == len(whole) == 2
    rows = slice(3 * rank, 3 * rank + 3)
    for got, want, one in zip(_epochs(ours), _epochs(theirs), _epochs(whole)):
        for g, w, o in zip(got, want, one):
            assert g["feats"].shape == (3, 5, 24, 16)
            for key in KEYS:
                assert np.array_equal(g[key], w[key]), key
                assert np.array_equal(g[key], o[key][rows]), key
            assert g["slide_ids"] == list(w["slide_ids"]) == o["slide_ids"][rows]
        assert got[-1]["sample_mask"].tolist() == [True, True, rank == 0]


def test_train_loader_needs_per_case_seed_under_several_processes(tmp_path):
    """A batch-seeded subsample depends on which rows a process loads, so
    several processes need per_case_seed (JAX datasets.py:171-174); the
    global batch must split evenly."""
    csv_path, feats, _ = TP._write_cohort(str(tmp_path), 4, 8)
    ds = D.SlideDataset("ACROBAT", csv_path, feats, STAINS, embedding_size=8, sample=4)
    with pytest.raises(ValueError, match="per_case_seed"):
        D.TrainLoader(ds, 4, process_count=2)
    ds.per_case_seed = True
    with pytest.raises(ValueError, match="not divisible"):
        D.TrainLoader(ds, 4, process_count=3)
    with pytest.raises(ValueError, match="process_index"):
        D.TrainLoader(ds, 4, process_index=2, process_count=2)


@pytest.mark.parametrize("max_tokens", [None, 30], ids=["whole", "capped"])
def test_ragged_loader_ranks_agree_on_the_bucket(tmp_path, max_tokens):
    """11 cases in global batches of 4 over 2 processes, buckets (16, 32),
    one bag of 70 tokens: every batch of both ranks is the JAX package's
    RaggedTrainLoader's at that rank bit for bit (epochs 0 and 1), both
    ranks pad each batch to the global batch's bucket (128 where the bag of
    70 is in it, whichever rank loads it, else 64; 32 when capped at 30), and each
    rank's truncation count is JAX's."""
    csv_path, feats = TR._write_cohort(str(tmp_path), TR._ragged_lengths(11))
    kw = dict(embedding_size=8, sample=-1)
    buckets, counts = [], []
    for rank in (0, 1):
        lk = dict(buckets=(16, 32), seed=3, max_tokens=max_tokens, process_index=rank,
                  process_count=2)
        ours = D.RaggedTrainLoader(D.SlideDataset("ACROBAT", csv_path, feats, STAINS, **kw), 4,
                                   **lk)
        theirs = JD.RaggedTrainLoader(JD.SlideDataset("ACROBAT", csv_path, feats, STAINS, **kw),
                                      4, **lk)
        mine = []
        for got, want in zip(_epochs(ours), _epochs(theirs)):
            assert len(got) == len(want) == 3
            for g, w in zip(got, want):
                for key in KEYS + ("token_mask",):
                    assert g[key].dtype == w[key].dtype and np.array_equal(g[key], w[key]), key
                assert g["slide_ids"] == list(w["slide_ids"])
                mine.append(g["feats"].shape[2])
        assert ours.truncation_count == theirs.truncation_count
        buckets.append(mine)
        counts.append(ours.truncation_count)
    assert buckets[0] == buckets[1]
    assert set(buckets[0]) == ({64, 128} if max_tokens is None else {32})
    assert (sum(counts) > 0) == (max_tokens is not None)
