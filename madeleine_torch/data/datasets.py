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
- `BucketedBagLoader`: bags of any length grouped by length bucket and padded
  into ``[b, T_bucket, d]`` batches with a ``[b, T_bucket]`` mask, so many
  slides run per kernel launch instead of the reference's batch_size=1 loop
  (ref: setup_components.py:162-168).
- `Prefetcher`: a background thread that runs any batch iterable ahead.

Not ported: the full-bag `RaggedTrainLoader` (ROADMAP.md A6) and the native
``.bag`` batch assembler (A5).
"""

from __future__ import annotations

import csv
import os
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from madeleine_torch.data.io import bag_length, list_bags, load_features


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
    is dropped. One process (data parallelism is ROADMAP.md A7)."""

    def __init__(self, dataset: SlideDataset, batch_size: int, seed: int = 0):
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
            sample_mask = np.arange(bs) < n_valid
            out = collate([self.dataset[i] for i in idx])
            out["modality_labels"][~sample_mask] = 0.0   # mask the padding rows
            out["sample_mask"] = sample_mask
            yield out


# ---------------------------------------------------------------------------
# Inference loaders
# ---------------------------------------------------------------------------

DEFAULT_BUCKETS = (512, 1024, 2048, 4096, 8192, 16384, 32768, 65536)


def grow_bucket(n: int, top: int) -> int:
    """Power-of-two bucket above the configured top one: bags run whole,
    never truncated (the reference's eval runs bags uncapped)."""
    b = max(top, 1)
    while b < n:
        b *= 2
    return b


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
        for b in self.buckets:
            if n <= b:
                return b
        return grow_bucket(n, self.buckets[-1])

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
