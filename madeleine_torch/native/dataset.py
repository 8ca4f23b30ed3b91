"""The native training loaders over ``.bag`` files (port of
`madeleine_tpu/native/dataset.py`: `NativeTrainLoader`, :21, and the
full-bag `NativeRaggedLoader`, :233).

Per batch it draws the subsample index matrix in the host library
(`bagio.sample_indices`, one generator draw a batch for its seed) and hands
the whole [bs * n_mod] gather to the library's thread pool, which writes
the batch into one slot of a ring of output tensors allocated once (pinned
when the loader feeds the card), missing stains zero-filled (ref
placeholder semantics: wsi_dataset.py:66). The generator calls are the JAX
package's, so the batches are equal to its loader's bit for bit.

The ring's guard: each slot carries a CUDA event that the consumer records
right after the asynchronous copy that reads the slot (the batch's
``"copied"`` entry; `train/trainer.py` records it); the loader waits on
that event before it refills the slot, so a copy still in flight is never
overwritten, whether or not the consumer syncs the host each step.

`NativeRaggedLoader` pads every bag of a batch to the batch's length
bucket: the library's assembler writes zeros for rows past a bag's length,
so the batch is one gather of rows [0, t), and the token mask comes from
the lengths in the bags' headers. Its ring's slots are flat, each sized
once, at construction, for the largest bucket the headers allow, so no
slot is ever replaced and ``pinned_bytes`` is all the pinned memory the
ring holds.

Data parallelism (JAX :59-67,112,192): with ``process_count`` > 1,
``batch_size`` is the global batch; every rank draws the same (seed, epoch)
shuffle and assembles only its contiguous row block into its ring, whose
slots hold ``batch_size // process_count`` rows. A subsampled loader then
needs ``per_case_seed`` (a bag's draw a function of (seed, epoch, case,
stain), whichever rank loads it); the ragged loader takes its bucket from
the headers of the global batch's bags, so every rank pads to one shape.
"""

from __future__ import annotations

import csv
import os
import time
from typing import Dict, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from madeleine_torch.data.datasets import RAGGED_BUCKETS, bucket_of
from madeleine_torch.native import bagio
from madeleine_torch.parallel.multihost import local_rows
from madeleine_torch.utils.device import resolve_device


class NativeTrainLoader:
    """Batches ``{"feats": [lbs, n_mod, t, d] tensor (a ring slot), "modality_labels",
    "sample_mask", "slide_ids", "copied": the slot's CUDA event or None}``.

    The arguments are the JAX package's; ``device`` (the card unless the CPU
    is named) decides whether the ring is pinned, and ``plain`` takes the
    library's plain versions (`bagio.sample_indices_plain`,
    `bagio.assemble_batch_plain`) for checks. ``timings`` holds, for each
    batch of the current epoch, the index draw's, the guard's wait and the
    assembly's ms. With ``process_count`` > 1 a batch is rank
    ``process_index``'s ``batch_size // process_count`` rows of the global
    batch."""

    _FULL_BAGS = False   # sample -1 (every token of a bag) is a subclass's

    def __init__(self, csv_path: str, bag_dir: str, modalities: Sequence[str],
                 embedding_size: int, sample: int, batch_size: int, shuffle: bool = True,
                 rng: Optional[np.random.Generator] = None, n_threads: int = 8,
                 pad_final: bool = True, seed: int = 0, buffer_depth: int = 4,
                 per_case_seed: bool = False, process_index: int = 0, process_count: int = 1,
                 out_dtype: str = "float32",
                 device: Optional[Union[str, torch.device]] = None, plain: bool = False):
        self._rows = local_rows(batch_size, process_index, process_count)
        if process_count > 1 and not per_case_seed and not self._FULL_BAGS:
            raise ValueError("multi-process subsampled loading requires per_case_seed=True")
        if sample < 1 and not self._FULL_BAGS:
            raise ValueError(f"sample {sample}: full bags (sample -1) are NativeRaggedLoader's")
        if out_dtype not in bagio.OUT_DTYPES:
            raise ValueError(f"out_dtype {out_dtype!r}: one of {sorted(bagio.OUT_DTYPES)}")
        with open(csv_path, newline="") as f:
            self.rows = list(csv.DictReader(f))
        self.bag_dir = bag_dir
        self.modalities = list(modalities)
        self.d = embedding_size
        self.sample = sample
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = rng or np.random.default_rng(seed)
        self.n_threads = n_threads
        self.pad_final = pad_final
        self.seed = seed
        self.epoch = 0
        self.per_case_seed = per_case_seed
        self.local_batch = batch_size // process_count
        self.out_dtype = out_dtype
        self.plain = plain
        self.device = resolve_device(device)
        opener = bagio.PlainBag if plain else bagio.BagReader

        # every present (case, stain) bag opened once (mmaps, cheap)
        self.readers: List[List[Optional[bagio.BagReader]]] = []
        self.labels = np.zeros((len(self.rows), len(self.modalities)), np.float32)
        n_missing = 0
        for i, row in enumerate(self.rows):
            split = row.get("split") or "train"   # an empty cell means train
            suffix = "" if split == "train" else f"_{split}"
            case: List[Optional[bagio.BagReader]] = []
            for m_idx, m in enumerate(self.modalities):
                path = os.path.join(bag_dir, f"{row['slide_id']}_{m}{suffix}.bag")
                reader = None
                if int(float(row[m])) == 1:
                    if os.path.exists(path):
                        reader = opener(path)
                        self.labels[i, m_idx] = 1.0
                    else:   # listed but absent: an absent stain, said once below
                        n_missing += 1
                case.append(reader)
            self.readers.append(case)
        if n_missing:
            print(f"* warning: {n_missing} (case, stain) bags listed in the "
                  f"csv are missing from {bag_dir}; treated as absent stains")

        # the ring: batch k is assembled into slot k % depth, so a consumer
        # (a Prefetcher of depth <= depth - 2) holds earlier batches intact
        depth = max(2, buffer_depth)
        self._pin = self.device.type == "cuda"
        numel = self.local_batch * len(self.modalities) * self._slot_tokens() * self.d
        self._ring = [self._new_slot(numel) for _ in range(depth)]
        self._events = [torch.cuda.Event() if self._pin else None for _ in range(depth)]
        self._slot = 0
        self.timings: List[Dict[str, float]] = []

    def _slot_tokens(self) -> int:
        """Tokens per bag that a ring slot holds."""
        return self.sample

    def _new_slot(self, numel: int) -> torch.Tensor:
        """A flat ring slot of `numel` elements, pinned when the loader feeds the card."""
        return torch.zeros(numel, dtype=bagio.OUT_DTYPES[self.out_dtype], pin_memory=self._pin)

    @property
    def pinned_bytes(self) -> int:
        """Bytes of pinned host memory the ring holds (0 for a CPU loader)."""
        return sum(x.numel() * x.element_size() for x in self._ring) if self._pin else 0

    def __len__(self) -> int:
        n, bs = len(self.rows), self.batch_size
        return (n + bs - 1) // bs if self.pad_final else n // bs

    def set_epoch(self, epoch: int) -> None:
        """(seed, epoch)-derived generator, so a resumed run replays the epoch."""
        self.rng = np.random.default_rng((self.seed, epoch))
        self.epoch = epoch

    def _indices_for(self, reader, case_idx: int, m_idx: int) -> np.ndarray:
        """One (case, stain)'s subsample under per_case_seed: a pure function
        of (seed, epoch, case, stain), unsorted (`permutation(n)[:t]`)."""
        t = self.sample
        if reader is None:
            return np.zeros(t, np.int64)
        rng = np.random.default_rng((self.seed, self.epoch, case_idx, m_idx))
        n = reader.n_rows
        if n < t:   # with replacement (ref: wsi_dataset.py:44-46)
            return rng.integers(0, n, size=t).astype(np.int64)
        return rng.permutation(n)[:t].astype(np.int64)

    def _batch_indices(self, sel: np.ndarray) -> np.ndarray:
        """The subsample index matrix [bs * n_mod, t] of one batch."""
        n_mod = len(self.modalities)
        if self.per_case_seed:
            return np.stack([self._indices_for(self.readers[i][m], int(i), m)
                             for i in sel for m in range(n_mod)])
        n_rows = np.asarray([0 if r is None else r.n_rows for i in sel for r in self.readers[i]],
                            np.int64)
        draw = bagio.sample_indices_plain if self.plain else bagio.sample_indices
        return draw(int(self.rng.integers(0, 2 ** 63)), n_rows, self.sample)

    def _assemble(self, readers, indices: np.ndarray, t0: float):
        """(the batch [n_tasks, t, d] of `indices`, its slot's event): assembled
        into the first n_tasks * t * d elements of the ring's next slot once
        that slot's last copy to the card has completed. Appends the batch's
        timings, the draw's from t0."""
        t1 = time.perf_counter()
        slot, event = self._slot, self._events[self._slot]
        self._slot = (slot + 1) % len(self._ring)
        if event is not None:
            event.synchronize()   # the slot's last copy to the card has completed
        t2 = time.perf_counter()
        n_tasks, t = indices.shape
        buf = self._ring[slot][:n_tasks * t * self.d].view(n_tasks, t, self.d)
        if self.plain:
            buf.copy_(bagio.assemble_batch_plain(readers, indices, self.d, buf.dtype))
        else:
            bagio.assemble_batch(readers, indices, self.d, buf, n_threads=self.n_threads)
        self.timings.append({"draw_ms": (t1 - t0) * 1e3, "guard_wait_ms": (t2 - t1) * 1e3,
                             "assemble_ms": (time.perf_counter() - t2) * 1e3})
        return buf, event

    def __iter__(self) -> Iterator[Dict]:
        order = np.arange(len(self.rows))
        if self.shuffle:
            self.rng.shuffle(order)
        bs, n_mod, t = self.batch_size, len(self.modalities), self.sample
        lbs = self.local_batch
        self.timings = []
        for start in range(0, len(order), bs):
            sel = order[start:start + bs]
            n_valid = len(sel)
            if n_valid < bs:
                if not self.pad_final:
                    break
                sel = np.concatenate([sel, np.repeat(sel[:1], bs - n_valid)])
            sel, mask = sel[self._rows], (np.arange(bs) < n_valid)[self._rows]
            readers = [self.readers[i][m] for i in sel for m in range(n_mod)]
            t0 = time.perf_counter()
            feats, event = self._assemble(readers, self._batch_indices(sel), t0)
            labels = self.labels[sel].copy()
            labels[~mask] = 0.0
            yield {"feats": feats.view(lbs, n_mod, t, self.d), "modality_labels": labels,
                   "sample_mask": mask,
                   "slide_ids": [str(self.rows[i]["slide_id"]) for i in sel],
                   "copied": event}

    def close(self) -> None:
        for case in self.readers:
            for r in case:
                if r is not None:
                    r.close()


class NativeRaggedLoader(NativeTrainLoader):
    """Full-bag (ragged) batches from ``.bag`` files (`madeleine_tpu/native/
    dataset.py:233-320`): ``{"feats": [bs, n_mod, t, d] tensor (a view of a
    ring slot), "modality_labels", "token_mask": [bs, n_mod, t] bool,
    "sample_mask", "slide_ids": the valid cases', "copied"}``. The bucket t
    is the smallest of ``buckets`` that holds the batch's longest bag, read
    from the bags' headers (capped at ``max_tokens`` when set; every capped
    bag counted in ``truncation_count``; buckets grow past the top
    otherwise); a missing stain is an all-masked bag. Every ring slot holds
    a batch of the largest bucket of the cohort. The arguments are
    `NativeTrainLoader`'s with ``sample`` -1; ``timings``' ``draw_ms`` is the
    index matrix's build."""

    _FULL_BAGS = True

    def __init__(self, *args, buckets: Sequence[int] = RAGGED_BUCKETS,
                 max_tokens: Optional[int] = None, **kw):
        kw.setdefault("sample", -1)
        self.buckets = sorted(buckets)
        self.max_tokens = max_tokens
        self.truncation_count = 0
        super().__init__(*args, **kw)

    def _slot_tokens(self) -> int:
        """The largest bucket a batch can take, from the bags' headers."""
        longest = max((r.n_rows for case in self.readers for r in case if r is not None),
                      default=1)
        if self.max_tokens is not None:
            longest = min(longest, self.max_tokens)
        return bucket_of(longest, self.buckets)

    def _cap(self, n: int) -> int:
        if self.max_tokens is not None and n > self.max_tokens:
            self.truncation_count += 1
            return self.max_tokens
        return n

    def __iter__(self) -> Iterator[Dict]:
        order = np.arange(len(self.rows))
        if self.shuffle:
            self.rng.shuffle(order)
        bs, n_mod, lbs = self.batch_size, len(self.modalities), self.local_batch
        self.timings = []
        for start in range(0, len(order), bs):
            sel = order[start:start + bs]
            n_valid = len(sel)
            if n_valid < bs:
                if not self.pad_final:
                    break
                sel = np.concatenate([sel, np.repeat(sel[:1], bs - n_valid)])
            # the global batch's bucket from the headers alone (no row is read)
            lengths = [0 if r is None else self._cap(r.n_rows)
                       for i in sel for r in self.readers[i]]
            t = bucket_of(max(lengths) if lengths else 1, self.buckets)
            sel, mask = sel[self._rows], (np.arange(bs) < n_valid)[self._rows]
            readers = [self.readers[i][m] for i in sel for m in range(n_mod)]
            cap_t = t if self.max_tokens is None else min(self.max_tokens, t)
            lengths = np.asarray([0 if r is None else min(r.n_rows, cap_t) for r in readers],
                                 np.int64)
            t0 = time.perf_counter()
            indices = np.ascontiguousarray(np.broadcast_to(np.arange(t, dtype=np.int64),
                                                           (len(readers), t)))
            feats, event = self._assemble(readers, indices, t0)
            labels = self.labels[sel].copy()
            labels[~mask] = 0.0
            yield {"feats": feats.view(lbs, n_mod, t, self.d), "modality_labels": labels,
                   "token_mask": (np.arange(t)[None, :] < lengths[:, None]).reshape(lbs, n_mod, t),
                   "sample_mask": mask,
                   "slide_ids": [str(self.rows[i]["slide_id"]) for i, v in zip(sel, mask) if v],
                   "copied": event}
