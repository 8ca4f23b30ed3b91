"""Datasets and loaders: multistain training cases, length-bucketed
inference batches and a prefetch thread.

Port of `madeleine_tpu/data/datasets.py` (ref: madeleine/datasets/wsi_dataset.py):

- `SlideDataset` + `collate` + `TrainLoader`: one item is one case, its
  per-stain bags ``{slide_id}_{stain}{split suffix}.h5`` (or ``.npz``, or
  ``.bag``) subsampled to a fixed token count, with replacement when a bag
  is short, and a zero placeholder for a missing stain, masked by its
  modality label (ref: wsi_dataset.py:21-99). The loader shuffles per epoch
  from (seed, epoch) and pads the last batch with masked rows, with the same
  numpy generator calls as the JAX package, so the batches are equal bit for
  bit. The cohort CSV is read with the `csv` module (no pandas).
- `RaggedTrainLoader`: full-bag training batches (`--n_subsamples -1`, the
  JAX package's default): every (case, stain) bag of a batch padded to the
  batch's length bucket (1024 ... 16384, powers of two past the top) with a
  [bs, n_mod, t] token mask, the same generator calls as the JAX package's
  (datasets.py:216-320), so the batches are equal bit for bit.
- Data parallelism: both train loaders take ``process_index`` and
  ``process_count``; ``batch_size`` is the global batch, every rank draws
  the same (seed, epoch) shuffle and yields only its contiguous row block
  (`parallel/multihost.py::local_rows`). Under several processes the
  subsample needs ``per_case_seed`` (a case's tokens a function of (seed,
  epoch, case, stain), whichever rank loads it), and the ragged loader
  agrees on the global batch's bucket from the bags' headers
  (`SlideDataset.bag_length_of`) without loading another rank's rows.
- `BucketedBagLoader`: bags of any length grouped by length bucket and padded
  into ``[b, T_bucket, d]`` batches with a ``[b, T_bucket]`` mask, so many
  slides run per kernel launch instead of the reference's batch_size=1 loop
  (ref: setup_components.py:162-168).
- `Prefetcher`: a background thread that runs any batch iterable ahead.

The native ``.bag`` loaders, which the pretrain CLI takes on a ``.bag``
cohort, are `madeleine_torch/native/dataset.py` `NativeTrainLoader` and
`NativeRaggedLoader`.
"""

from __future__ import annotations

import csv
import os
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from madeleine_torch.data.io import bag_length, list_bags, load_features
from madeleine_torch.parallel.multihost import local_rows


# ---------------------------------------------------------------------------
# Train dataset
# ---------------------------------------------------------------------------


class SlideDataset:
    """Multistain training cases (ref: wsi_dataset.py:21-84). The CSV has a
    ``slide_id`` column, one 0/1 column per stain and optionally ``split``."""

    def __init__(self, dataset_name: str, csv_path: str, features_path: str,
                 modalities: Sequence[str], embedding_size: Optional[int] = None,
                 sample: int = -1, per_case_seed: bool = False, seed: int = 0):
        self.dataset_name = dataset_name
        with open(csv_path, newline="") as f:
            self.rows = list(csv.DictReader(f))
        self.features_path = features_path
        self.modalities = list(modalities)
        self.sample = sample
        self.embedding_size = embedding_size
        self.rng = np.random.default_rng(seed)   # TrainLoader.set_epoch reseeds it
        # per-case seeding makes each case's subsample a pure function of
        # (seed, epoch, case, stain), whichever process loads it
        self.per_case_seed = per_case_seed
        self.seed = seed
        self.epoch = 0

    def __len__(self) -> int:
        return len(self.rows)

    def sample_n(self, feats: np.ndarray,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """Fixed-size token subsample; with replacement when the bag is short
        (ref: wsi_dataset.py:42-50)."""
        rng = rng if rng is not None else self.rng
        if self.sample > -1:
            n = feats.shape[0]
            if n < self.sample:
                idx = rng.integers(0, n, size=self.sample)
            else:
                idx = rng.permutation(n)[: self.sample]
            feats = feats[idx]
        return feats

    def bag_length_of(self, index: int, modality: str) -> int:
        """Token count of one (case, stain) bag from its header alone (0 when
        the stain is absent): lets the ranks of a ragged loader agree on the
        global batch's bucket without loading each other's rows."""
        row = self.rows[index]
        if int(float(row[modality])) != 1:
            return 0
        return bag_length(self._bag_path(row, modality))

    def _bag_path(self, row: Dict[str, str], modality: str) -> str:
        split_type = row.get("split") or "train"
        special_id = "" if split_type == "train" else f"_{split_type}"
        path = os.path.join(self.features_path, f"{row['slide_id']}_{modality}{special_id}.h5")
        for ext in (".npz", ".bag"):
            if not os.path.exists(path) and os.path.exists(path[:-3] + ext):
                return path[:-3] + ext
        return path

    def __getitem__(self, index: int) -> Dict:
        row = self.rows[index]
        slide_id = row["slide_id"]
        modality_labels = [int(float(row[m])) for m in self.modalities]
        all_feats = []
        for m_idx, (modality, label) in enumerate(zip(self.modalities, modality_labels)):
            if label == 1:
                feats = load_features(self._bag_path(row, modality))
            else:
                # zero placeholder, masked out by its modality label (ref: wsi_dataset.py:66)
                feats = np.zeros((2, self.embedding_size), np.float32)
            rng = (np.random.default_rng((self.seed, self.epoch, index, m_idx))
                   if self.per_case_seed else None)
            all_feats.append(self.sample_n(feats, rng))
        return {"feats": all_feats, "modality_labels": modality_labels, "slide_id": slide_id}


def collate(batch: List[Dict]) -> Dict:
    """Stack cases into feats [bs, n_mod, t, d] f32 and modality_labels
    [bs, n_mod] (ref: wsi_dataset.py:86-99); bags must have one length."""
    feats = np.stack([np.stack(item["feats"]) for item in batch])
    labels = np.stack([np.asarray(item["modality_labels"], np.float32) for item in batch])
    return {"feats": feats.astype(np.float32), "modality_labels": labels,
            "slide_ids": [item["slide_id"] for item in batch]}


class TrainLoader:
    """Shuffling epoch iterator over a SlideDataset. The last short batch is
    padded to batch_size by repeating its first case with a zeroed modality
    mask and ``sample_mask`` False, so every step has one shape and no case
    is dropped. With ``process_count`` > 1, batch_size is the global batch
    and each batch is rank ``process_index``'s rows of it; the dataset must
    then draw per case (``per_case_seed``)."""

    def __init__(self, dataset: SlideDataset, batch_size: int, seed: int = 0,
                 process_index: int = 0, process_count: int = 1):
        self._rows = local_rows(batch_size, process_index, process_count)
        if process_count > 1 and not dataset.per_case_seed:
            raise ValueError("multi-process loading needs SlideDataset(per_case_seed=True) "
                             "so that the subsample does not depend on the process count")
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.set_epoch(0)

    def set_epoch(self, epoch: int) -> None:
        """Derive the epoch's generators from (seed, epoch), so that a resumed
        run replays the same shuffle and subsamples."""
        self.rng = np.random.default_rng((self.seed, epoch))
        self.dataset.rng = np.random.default_rng((self.seed, epoch, 1))
        self.dataset.epoch = epoch

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self) -> Iterator[Dict]:
        order = np.arange(len(self.dataset))
        self.rng.shuffle(order)
        bs = self.batch_size
        for start in range(0, len(order), bs):
            idx = order[start:start + bs]
            n_valid = len(idx)
            if n_valid < bs:
                idx = np.concatenate([idx, idx[np.zeros(bs - n_valid, np.int64)]])
            idx, sample_mask = idx[self._rows], (np.arange(bs) < n_valid)[self._rows]
            out = collate([self.dataset[i] for i in idx])
            out["modality_labels"][~sample_mask] = 0.0   # mask the padding rows
            out["sample_mask"] = sample_mask
            yield out


def grow_bucket(n: int, top: int) -> int:
    """Power-of-two bucket above the configured top one: bags run whole,
    never truncated (the reference's eval runs bags uncapped)."""
    b = max(top, 1)
    while b < n:
        b *= 2
    return b


RAGGED_BUCKETS = (1024, 2048, 4096, 8192, 16384)


def bucket_of(n: int, buckets: Sequence[int]) -> int:
    """The smallest of the (sorted) buckets that holds n tokens, else a grown one."""
    for b in buckets:
        if n <= b:
            return b
    return grow_bucket(n, buckets[-1])


class RaggedTrainLoader:
    """Full-bag multistain training batches ``{"feats": [bs, n_mod, t, d] f32,
    "modality_labels", "token_mask": [bs, n_mod, t] bool, "sample_mask",
    "slide_ids": the valid cases'}``: no token subsampling; each bag padded
    with zeros to the batch's bucket t, the smallest bucket that holds its
    longest bag (capped at ``max_tokens`` when set). The reference cannot
    train on whole bags (it subsamples to 2048, ref: wsi_dataset.py:42-50).
    ``max_tokens`` None keeps bags whole (buckets grow past the top); a cap
    truncates and counts every capped bag in ``truncation_count``. A missing
    stain is the dataset's 2-row zero placeholder, masked by its label. The
    last short batch is padded by repeating its first case, masked. With
    ``process_count`` > 1, batch_size is the global batch and each batch is
    rank ``process_index``'s rows of it, padded to the global batch's bucket
    (`_global_bucket`, from the bags' headers), so every rank's batch has
    one shape."""

    def __init__(self, dataset: SlideDataset, batch_size: int,
                 buckets: Sequence[int] = RAGGED_BUCKETS, shuffle: bool = True, seed: int = 0,
                 max_tokens: Optional[int] = None, process_index: int = 0,
                 process_count: int = 1):
        self._rows = local_rows(batch_size, process_index, process_count)
        self.multi_process = process_count > 1
        if dataset.sample != -1:
            raise ValueError("RaggedTrainLoader expects sample=-1 datasets")
        self.dataset = dataset
        self.batch_size = batch_size
        self.buckets = sorted(buckets)
        self.shuffle = shuffle
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.max_tokens = max_tokens
        self.truncation_count = 0

    def set_epoch(self, epoch: int) -> None:
        """(seed, epoch)-derived shuffle, so that a resumed run replays the epoch."""
        self.rng = np.random.default_rng((self.seed, epoch))
        self.dataset.epoch = epoch

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def _cap(self, n: int) -> int:
        return n if self.max_tokens is None else min(n, self.max_tokens)

    def _global_bucket(self, idx: np.ndarray) -> int:
        """The bucket of the global batch `idx` from the bags' headers alone
        (JAX datasets.py:276-283), so that every rank pads to one shape."""
        longest = 1
        for i in idx:
            for m in self.dataset.modalities:
                longest = max(longest, self.dataset.bag_length_of(int(i), m))
        return bucket_of(self._cap(longest), self.buckets)

    def __iter__(self) -> Iterator[Dict]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        bs = self.batch_size
        for start in range(0, len(order), bs):
            idx = order[start:start + bs]
            n_valid = len(idx)
            if n_valid < bs:
                idx = np.concatenate([idx, np.repeat(idx[:1], bs - n_valid)])
            t = self._global_bucket(idx) if self.multi_process else None
            idx, sample_mask = idx[self._rows], (np.arange(bs) < n_valid)[self._rows]
            items = [self.dataset[i] for i in idx]
            if t is None:   # one process: the bucket of the rows it loaded
                t = bucket_of(self._cap(max(f.shape[0] for it in items for f in it["feats"])),
                              self.buckets)
            lbs, n_mod, d = len(items), len(items[0]["feats"]), items[0]["feats"][0].shape[1]
            feats = np.zeros((lbs, n_mod, t, d), np.float32)
            token_mask = np.zeros((lbs, n_mod, t), bool)
            labels = np.zeros((lbs, n_mod), np.float32)
            for b, item in enumerate(items):
                for m, f in enumerate(item["feats"]):
                    n = min(f.shape[0], t)
                    if f.shape[0] > t:   # only under an explicit cap
                        self.truncation_count += 1
                    feats[b, m, :n] = f[:n]
                    token_mask[b, m, :n] = True
                labels[b] = np.asarray(item["modality_labels"], np.float32)
            labels[~sample_mask] = 0.0
            yield {"feats": feats, "modality_labels": labels, "token_mask": token_mask,
                   "sample_mask": sample_mask,
                   "slide_ids": [it["slide_id"] for it, v in zip(items, sample_mask) if v]}


# ---------------------------------------------------------------------------
# Inference loaders
# ---------------------------------------------------------------------------

DEFAULT_BUCKETS = (512, 1024, 2048, 4096, 8192, 16384, 32768, 65536)


class BucketedBagLoader:
    """Yields ``{"feats": [b, T, d] f32, "mask": [b, T] bool, "slide_ids",
    "n_valid"}``. The token budget per batch bounds padding and device
    memory; batch sizes are powers of two and the tail batch is padded with
    masked zero rows."""

    def __init__(self, features_path: str, buckets: Sequence[int] = DEFAULT_BUCKETS,
                 tokens_per_batch: int = 262144, max_batch: int = 64,
                 dtype=np.float32):
        self.features_path = features_path
        self.buckets = sorted(buckets)
        self.tokens_per_batch = tokens_per_batch
        self.max_batch = max_batch
        self.dtype = dtype
        self.fnames = list(list_bags(features_path))

    def __len__(self) -> int:
        return len(self.fnames)

    def _bucket_of(self, n: int) -> int:
        return bucket_of(n, self.buckets)

    @staticmethod
    def _pow2_floor(x: int) -> int:
        return 1 << (max(x, 1).bit_length() - 1)

    def __iter__(self) -> Iterator[Dict]:
        groups: Dict[int, List[str]] = {}
        for fn in self.fnames:
            n = bag_length(os.path.join(self.features_path, fn))
            groups.setdefault(self._bucket_of(n), []).append(fn)

        for bucket in sorted(groups):
            fns = groups[bucket]
            bs = self._pow2_floor(max(1, min(self.max_batch,
                                             self.tokens_per_batch // bucket)))
            for start in range(0, len(fns), bs):
                chunk = fns[start:start + bs]
                feats = None
                mask = np.zeros((bs, bucket), bool)
                ids = []
                for j, fn in enumerate(chunk):
                    f = load_features(os.path.join(self.features_path, fn), self.dtype)
                    if feats is None:
                        feats = np.zeros((bs, bucket, f.shape[1]), self.dtype)
                    feats[j, : f.shape[0]] = f
                    mask[j, : f.shape[0]] = True
                    ids.append(os.path.splitext(fn)[0])
                yield {"feats": feats, "mask": mask, "slide_ids": ids,
                       "n_valid": len(ids)}


class Prefetcher:
    """Runs the wrapped iterable in a background thread, `depth` items ahead,
    so host reads overlap device work. Errors re-raise in the consumer."""

    def __init__(self, iterable, depth: int = 2):
        self.iterable = iterable
        self.depth = depth

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        sentinel = object()
        err: List[BaseException] = []

        def worker():
            try:
                for item in self.iterable:
                    q.put(item)
            except BaseException as e:
                err.append(e)
            finally:
                q.put(sentinel)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item
