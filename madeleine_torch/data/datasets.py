"""Inference loaders: length-bucketed padded batches and a prefetch thread.

Port of the inference half of `madeleine_tpu/data/datasets.py`: bags of any
length are grouped by length bucket and padded into ``[b, T_bucket, d]``
batches with a ``[b, T_bucket]`` mask, so many slides run per kernel launch
instead of the reference's batch_size=1 loop (ref: setup_components.py:162-168).
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Iterator, List, Sequence

import numpy as np

from madeleine_torch.data.io import bag_length, list_bags, load_features

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
