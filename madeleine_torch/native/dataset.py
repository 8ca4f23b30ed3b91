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

The ring's guard (`SlotGuard`, a batch's ``"copied"`` entry): each pinned
slot carries a CUDA event that the consumer records, by calling
``copied.record()``, right after the asynchronous copy that reads the slot
(`train/trainer.py` does). The loader refills a slot only once the batch it
last held has been recorded (a host flag that ``record()`` sets) and that
copy has completed (the event), so neither a batch still queued in a
`Prefetcher` nor a copy in flight is ever overwritten, at any ring depth.
**Every consumer of a pinned ring records every batch it takes**, or the
loader waits for it forever (there is no timeout: a step may take seconds).

The ring's depth on the card: ``clamp(MemTotal / 4 // slot bytes, 2,
buffer_depth)`` (`ring_depth`), so 4 slots of a batch of 65 x 5 x 2048 bf16
tokens and 2 of one of 65 x 5 x 32768; a ring whose 2 slots pass the host's
available memory is refused before anything is pinned. The depth changes no
batch. Each pinned slot page-locks exactly its bytes (`PageLocked`, by
cudaHostRegister; PyTorch's pinned allocator would round it up to a power
of two), so ``pinned_bytes`` is what the ring holds; a slot no ring holds
any more stays registered as a spare for the next ring of its size in the
process, until `release_spare` (spares count as available memory). A CPU
ring is not pinned, its batches carry no guard, and it keeps ``max(2,
buffer_depth)`` slots: a consumer (a Prefetcher of depth at most the
ring's depth less 2) then holds earlier batches intact.

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
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from madeleine_torch.data.datasets import RAGGED_BUCKETS, bucket_of
from madeleine_torch.native import bagio
from madeleine_torch.parallel.multihost import local_rows
from madeleine_torch.utils.device import resolve_device

RING_BUDGET_SHARE = 4   # a ring pins at most MemTotal / 4, or its 2 slots where they pass that


def host_memory() -> Dict[str, int]:
    """MemTotal and MemAvailable of the host, bytes (/proc/meminfo)."""
    with open("/proc/meminfo") as f:
        kb = {ln.split(":")[0]: int(ln.split()[1]) for ln in f if ln.split()}
    return {k: kb[k] * 1024 for k in ("MemTotal", "MemAvailable")}


def ring_depth(slot_bytes: int, buffer_depth: int, mem_total: int) -> int:
    """Slots of a pinned ring: as many as a quarter of the host's memory
    holds, at least 2 and at most ``buffer_depth``."""
    fits = mem_total // RING_BUDGET_SHARE // max(1, slot_bytes)
    return max(2, min(buffer_depth, fits))


# page-locked buffers that no ring slot holds, all of one size: the next
# ring of that size in the process takes them (a run of CLI calls in one
# process builds the same ring each time); `release_spare` frees them
_SPARE: List[torch.Tensor] = []


def release_spare() -> int:
    """Unregister and free the spare page-locked buffers; returns their bytes."""
    freed = 0
    while _SPARE:
        buf = _SPARE.pop()
        torch.cuda.cudart().cudaHostUnregister(buf.data_ptr())
        freed += buf.numel()
    return freed


class PageLocked:
    """`nbytes` of host memory page-locked for the card by cudaHostRegister,
    exactly those bytes: PyTorch's pinned allocator would round a block up
    to a power of two (a 10.9 GB slot of the published batch at bucket
    32768 would pin 17.18 GB). The pages are touched first on the host's
    threads (zeroed), since cudaHostRegister faults untouched ones in one at a
    time; a spare buffer of the same size is taken instead where there is
    one. `tensor()` views them as uint8, and every tensor viewing them keeps
    this object alive (through numpy's array interface); once the last is
    gone, the buffer becomes a spare after the slot's last recorded copy
    (`guard`) has completed."""

    def __init__(self, nbytes: int, guard: Optional["SlotGuard"] = None):
        self._guard = guard
        if _SPARE and _SPARE[0].numel() != nbytes:
            release_spare()
        if _SPARE:
            self._buf = _SPARE.pop()
        else:
            buf = torch.zeros(nbytes, dtype=torch.uint8)
            rc = int(torch.cuda.cudart().cudaHostRegister(buf.data_ptr(), nbytes, 0))
            if rc != 0:
                raise RuntimeError(f"cudaHostRegister of {nbytes} bytes failed (cudaError {rc})")
            self._buf = buf
        self.__array_interface__ = {"data": (self._buf.data_ptr(), False),
                                    "shape": (nbytes,), "typestr": "|u1", "version": 3}

    def tensor(self) -> torch.Tensor:
        return torch.from_numpy(np.asarray(self))

    def __del__(self):
        buf = getattr(self, "_buf", None)
        if buf is None:
            return
        try:
            if self._guard is not None:
                self._guard.synchronize()
            _SPARE.append(buf)
        except Exception:   # interpreter teardown: the process unmaps it anyway
            pass


class SlotGuard:
    """A pinned ring slot's guard, handed out as its batch's ``"copied"``:
    ``record()`` records the slot's CUDA event on the current stream right
    after the copy that reads the slot and marks the batch as taken; the
    loader's `wait` returns once the slot's last batch was recorded and its
    copy has completed. ``query()`` / ``synchronize()`` are the event's."""

    def __init__(self, event):
        self.event = event
        self._recorded = threading.Event()
        self._recorded.set()   # a fresh slot holds no batch

    def record(self) -> None:
        self.event.record()
        self._recorded.set()

    def query(self) -> bool:
        return self.event.query()

    def synchronize(self) -> None:
        self.event.synchronize()

    def hand_out(self) -> "SlotGuard":
        """Mark the slot's new batch as not yet taken by its consumer."""
        self._recorded.clear()
        return self

    def wait(self) -> None:
        self._recorded.wait()
        self.event.synchronize()


class NativeTrainLoader:
    """Batches ``{"feats": [lbs, n_mod, t, d] tensor (a ring slot), "modality_labels",
    "sample_mask", "slide_ids", "copied": the slot's SlotGuard or None}``.

    The arguments are the JAX package's; ``device`` (the card unless the CPU
    is named) decides whether the ring is pinned, and ``plain`` takes the
    library's plain versions (`bagio.sample_indices_plain`,
    `bagio.assemble_batch_plain`) for checks. ``timings`` holds, for each
    batch of the current epoch, the index draw's, the guard's wait and the
    assembly's ms. With ``process_count`` > 1 a batch is rank
    ``process_index``'s ``batch_size // process_count`` rows of the global
    batch. On the card the ring is pinned and ``ring_depth`` slots deep
    (the module's rule), and the consumer must call ``batch["copied"].record()``
    after the copy of every batch it takes, before it asks for the batch
    ``ring_depth`` later; a ring whose 2 slots pass the host's
    ``MemAvailable`` raises ValueError."""

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

        # the ring: batch k is assembled into slot k % depth once the guard
        # of that slot's last batch allows it (pinned), or (CPU) as soon as
        # asked, which a consumer of depth <= depth - 2 survives
        self._pin = self.device.type == "cuda"
        numel = self.local_batch * len(self.modalities) * self._slot_tokens() * self.d
        slot_bytes = numel * bagio.OUT_DTYPES[out_dtype].itemsize
        if self._pin:
            mem = host_memory()
            depth = ring_depth(slot_bytes, buffer_depth, mem["MemTotal"])
            available = mem["MemAvailable"] + sum(buf.numel() for buf in _SPARE)
            if 2 * slot_bytes > available:
                raise ValueError(
                    f"the native ring's 2 pinned slots need {2 * slot_bytes} bytes "
                    f"({2 * slot_bytes / 1e9:.2f} GB: {self.local_batch} cases x "
                    f"{len(self.modalities)} stains x {self._slot_tokens()} tokens x {self.d} "
                    f"{out_dtype}) and the host has {available} bytes available; "
                    f"lower --batch_size or cap the bags' tokens (max_tokens)")
        else:
            depth = max(2, buffer_depth)
        self._guards = [self._new_guard() for _ in range(depth)]
        self._ring = [self._new_slot(numel, guard) for guard in self._guards]
        self._slot = 0
        self.timings: List[Dict[str, float]] = []

    def _slot_tokens(self) -> int:
        """Tokens per bag that a ring slot holds."""
        return self.sample

    def _new_slot(self, numel: int, guard: Optional[SlotGuard] = None) -> torch.Tensor:
        """A flat ring slot of `numel` elements: page-locked (`PageLocked`,
        its bytes exactly) when the loader feeds the card, else left unset
        (a batch's assembly writes every element it hands out)."""
        dtype = bagio.OUT_DTYPES[self.out_dtype]
        if not self._pin:
            return torch.empty(numel, dtype=dtype)
        return PageLocked(numel * dtype.itemsize, guard).tensor().view(dtype)

    def _new_guard(self) -> Optional[SlotGuard]:
        """A slot's guard: a SlotGuard on a CUDA event for a pinned ring, else None."""
        return SlotGuard(torch.cuda.Event()) if self._pin else None

    @property
    def pinned_bytes(self) -> int:
        """Bytes of pinned host memory the ring holds (0 for a CPU loader)."""
        return sum(x.numel() * x.element_size() for x in self._ring) if self._pin else 0

    @property
    def ring_depth(self) -> int:
        """The ring's slots."""
        return len(self._ring)

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
        """(the batch [n_tasks, t, d] of `indices`, its slot's guard): assembled
        into the first n_tasks * t * d elements of the ring's next slot once
        that slot's last batch was recorded and its copy to the card has
        completed. Appends the batch's timings, the draw's from t0."""
        t1 = time.perf_counter()
        slot, guard = self._slot, self._guards[self._slot]
        self._slot = (slot + 1) % len(self._ring)
        if guard is not None:
            guard.wait()   # the slot's last batch is taken and its copy has completed
        t2 = time.perf_counter()
        n_tasks, t = indices.shape
        buf = self._ring[slot][:n_tasks * t * self.d].view(n_tasks, t, self.d)
        if self.plain:
            buf.copy_(bagio.assemble_batch_plain(readers, indices, self.d, buf.dtype))
        else:
            bagio.assemble_batch(readers, indices, self.d, buf, n_threads=self.n_threads)
        self.timings.append({"draw_ms": (t1 - t0) * 1e3, "guard_wait_ms": (t2 - t1) * 1e3,
                             "assemble_ms": (time.perf_counter() - t2) * 1e3})
        return buf, None if guard is None else guard.hand_out()

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
            feats, guard = self._assemble(readers, self._batch_indices(sel), t0)
            labels = self.labels[sel].copy()
            labels[~mask] = 0.0
            yield {"feats": feats.view(lbs, n_mod, t, self.d), "modality_labels": labels,
                   "sample_mask": mask,
                   "slide_ids": [str(self.rows[i]["slide_id"]) for i in sel],
                   "copied": guard}

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
            feats, guard = self._assemble(readers, indices, t0)
            labels = self.labels[sel].copy()
            labels[~mask] = 0.0
            yield {"feats": feats.view(lbs, n_mod, t, self.d), "modality_labels": labels,
                   "token_mask": (np.arange(t)[None, :] < lengths[:, None]).reshape(lbs, n_mod, t),
                   "sample_mask": mask,
                   "slide_ids": [str(self.rows[i]["slide_id"]) for i, v in zip(sel, mask) if v],
                   "copied": guard}
