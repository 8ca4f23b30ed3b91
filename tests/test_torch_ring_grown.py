"""The native ring at grown buckets (`madeleine_torch/native/dataset.py`) on
the CPU: the ring's depth from the slot's bytes and the host's MemTotal
(`ring_depth`: 4 slots at every ring the smoke run built before, 2 at the
published batch of 65 at bucket 32768 in bf16 or 16384 in f32), the
refusal, before anything is pinned, of a ring whose 2 slots pass
MemAvailable (both read from /proc/meminfo, patched here), and the ring's
guard (`SlotGuard`) on a host stand-in for the slot's CUDA event: under a
`Prefetcher` of depth 2 over a ring of 2 slots and a slow consumer no slot
is refilled while the batch it holds is unrecorded or its copy unfinished,
and every batch equals the JAX package's `NativeRaggedLoader` bit for bit."""

import threading
import time

import numpy as np
import pytest
import torch

from madeleine_tpu.native import bagio as JB
from madeleine_tpu.native import dataset as JN
from madeleine_torch.data.datasets import Prefetcher
from madeleine_torch.native import bagio as B
from madeleine_torch.native import dataset as D
from tests.test_torch_native_loader import STAINS, _bits, _write_bag_cohort

GB = 10 ** 9
CARD_HOST = 108_447_924_224   # the H100 machine's MemTotal, bytes (/proc/meminfo)


@pytest.fixture(scope="module", autouse=True)
def jax_native_lib(tmp_path_factory):
    """The JAX package's library, built into this module's own temp dir when
    this process has not loaded it yet (its build writes straight to its
    output, which another test process may be building too)."""
    if JB._lib is not None:
        yield JB._lib
        return
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "_SO", str(tmp_path_factory.mktemp("jax_bagio") / "libbagio.so"))
        lib = JB.get_lib()
        assert lib is not None, "the JAX package's native library did not build"
        yield lib


@pytest.mark.parametrize("bs,bucket,dtype,mem_total,depth", [
    (65, 2048, "bfloat16", CARD_HOST, 4),    # the CLI at the launch script's 2048 tokens
    (65, 8192, "bfloat16", CARD_HOST, 4),    # pretrain_ragged
    (65, 16384, "bfloat16", CARD_HOST, 4),   # 5.45 GB a slot
    (8, 32768, "bfloat16", CARD_HOST, 4),    # the grown b = 8 sigmoid run
    (65, 2048, "float32", CARD_HOST, 4),
    (65, 8192, "float32", CARD_HOST, 4),     # pretrain_f32
    (65, 32768, "bfloat16", CARD_HOST, 2),   # 10.9 GB a slot: 21.81 GB, not 43.62
    (65, 16384, "float32", CARD_HOST, 2),
    (65, 65536, "float32", CARD_HOST, 2),    # at least 2, whatever the budget
    (65, 16384, "bfloat16", 54 * GB, 2),     # a smaller host
    (65, 32768, "bfloat16", 512 * GB, 4),    # a larger one: at most buffer_depth
])
def test_ring_depth_rule(bs, bucket, dtype, mem_total, depth):
    slot = bs * len(STAINS) * bucket * 512 * (2 if dtype == "bfloat16" else 4)
    assert D.ring_depth(slot, 4, mem_total) == depth
    assert D.ring_depth(slot, 8, mem_total) == max(2, min(8, mem_total // 4 // slot))
    assert D.ring_depth(slot, 1, mem_total) == 2


class HostEvent:
    """A host stand-in for a slot's CUDA event: a copy recorded now
    completes `copy_s` seconds later."""

    def __init__(self, copy_s=0.0):
        self.copy_s, self.done_at, self.records = copy_s, 0.0, 0

    def record(self):
        self.records += 1
        self.done_at = time.perf_counter() + self.copy_s

    def query(self):
        return time.perf_counter() >= self.done_at

    def synchronize(self):
        time.sleep(max(0.0, self.done_at - time.perf_counter()))


@pytest.fixture
def as_on_the_card(monkeypatch):
    """A loader built as on the card with no card: the device taken as
    CUDA, its slots on the meta device (nothing pinned; each slot's numel
    listed), its guards on host stand-ins. Returns the list of slots made."""
    made = []

    def new_slot(self, numel, guard=None):
        made.append(numel)
        return torch.empty(numel, dtype=B.OUT_DTYPES[self.out_dtype], device="meta")

    monkeypatch.setattr(D, "resolve_device", lambda device: torch.device("cuda"))
    monkeypatch.setattr(D.NativeTrainLoader, "_new_slot", new_slot)
    monkeypatch.setattr(D.NativeTrainLoader, "_new_guard", lambda self: D.SlotGuard(HostEvent()))
    return made


RAGGED = dict(embedding_size=16, batch_size=4, seed=5, out_dtype="bfloat16", buckets=(16, 32))
SLOT = 4 * 5 * 64 * 16 * 2   # a batch of 4 at the cohort's largest bucket, 64, in bf16


@pytest.mark.parametrize("budget_slots,buffer_depth,depth", [
    (2.5, 4, 2), (3, 4, 3), (4, 4, 4), (100, 4, 4), (100, 3, 3), (1, 4, 2)])
def test_loader_depth_from_memtotal(tmp_path, monkeypatch, as_on_the_card, budget_slots,
                                    buffer_depth, depth):
    """The loader's ring on the card: as many slots as a quarter of
    MemTotal holds, at least 2, at most buffer_depth; pinned_bytes is every
    slot's, each sized once for the cohort's largest bucket."""
    csv_path, bags = _write_bag_cohort(str(tmp_path), 11, 16, disk="bfloat16")
    mem = {"MemTotal": int(4 * budget_slots * SLOT), "MemAvailable": 2 * SLOT}
    monkeypatch.setattr(D, "host_memory", lambda: mem)
    loader = D.NativeRaggedLoader(csv_path, bags, STAINS, buffer_depth=buffer_depth, **RAGGED)
    assert loader.ring_depth == depth and as_on_the_card == [SLOT // 2] * depth
    assert loader.pinned_bytes == depth * SLOT
    assert all(isinstance(g, D.SlotGuard) for g in loader._guards)
    loader.close()


def test_loader_refuses_a_ring_past_memavailable(tmp_path, monkeypatch, as_on_the_card):
    """2 slots past MemAvailable raise before a slot is made, naming the
    bytes, --batch_size and max_tokens; exactly 2 slots' worth is enough."""
    csv_path, bags = _write_bag_cohort(str(tmp_path), 11, 16, disk="bfloat16")
    monkeypatch.setattr(D, "host_memory",
                        lambda: {"MemTotal": CARD_HOST, "MemAvailable": 2 * SLOT - 1})
    with pytest.raises(ValueError, match="--batch_size") as e:
        D.NativeRaggedLoader(csv_path, bags, STAINS, **RAGGED)
    assert f"need {2 * SLOT} bytes" in str(e.value) and f"{2 * SLOT - 1} bytes" in str(e.value)
    assert "max_tokens" in str(e.value) and as_on_the_card == []
    monkeypatch.setattr(D, "host_memory",
                        lambda: {"MemTotal": 8 * SLOT, "MemAvailable": 2 * SLOT})
    loader = D.NativeRaggedLoader(csv_path, bags, STAINS, **RAGGED)
    assert loader.ring_depth == 2 and len(as_on_the_card) == 2
    loader.close()


def _guarded_cpu_loader(csv_path, bags, monkeypatch, copy_s=0.0):
    """A CPU NativeRaggedLoader of 2 slots whose slots carry guards on host
    stand-ins, and the assembler checked: every refill of a slot must find
    its last batch recorded and that copy complete (the list of violations)."""
    monkeypatch.setattr(D.NativeTrainLoader, "_new_guard",
                        lambda self: D.SlotGuard(HostEvent(copy_s)))
    loader = D.NativeRaggedLoader(csv_path, bags, STAINS, buffer_depth=2, device="cpu", **RAGGED)
    violations = []
    assemble = B.assemble_batch

    def checked(readers, indices, d, out, n_threads=8):
        slot = [x.data_ptr() for x in loader._ring].index(out.data_ptr())
        guard = loader._guards[slot]
        if not (guard._recorded.is_set() and guard.event.query()):
            violations.append(slot)
        return assemble(readers, indices, d, out, n_threads=n_threads)

    monkeypatch.setattr(B, "assemble_batch", checked)
    return loader, violations


def _ragged_snapshot(batch):
    return {"feats": np.array(_bits(batch["feats"])),   # a copy, not a view of the slot
            "token_mask": np.array(batch["token_mask"]),
            "modality_labels": np.array(batch["modality_labels"]),
            "sample_mask": np.array(batch["sample_mask"]),
            "slide_ids": [str(s) for s in batch["slide_ids"]]}


def test_two_slots_under_a_prefetcher_never_overwrite_a_batch(tmp_path, monkeypatch):
    """A ring of 2 slots under a Prefetcher of depth 2 (which would hold 2
    batches while the loader assembles a third) and a consumer that takes
    30 ms a batch, then copies and records it, for two epochs: no refill
    finds its slot's batch unrecorded, the loader waits at the third batch
    of each epoch, and every batch the consumer copies equals the JAX
    package's NativeRaggedLoader's bit for bit."""
    csv_path, bags = _write_bag_cohort(str(tmp_path), 11, 16, disk="bfloat16", empty_bag=True)
    loader, violations = _guarded_cpu_loader(csv_path, bags, monkeypatch)
    theirs = JN.NativeRaggedLoader(csv_path, bags, STAINS, **RAGGED)
    assert loader.ring_depth == 2
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got = []
        for b in Prefetcher(loader, depth=2):
            time.sleep(0.03)                       # the step before this batch's copy
            got.append(_ragged_snapshot(b))        # the copy
            b["copied"].record()
        want = [_ragged_snapshot(b) for b in theirs]
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            for key in ("feats", "token_mask", "modality_labels", "sample_mask", "slide_ids"):
                assert (np.array_equal(g[key], w[key]) if key != "slide_ids"
                        else g[key] == w[key]), (epoch, key)
        assert loader.timings[2]["guard_wait_ms"] > 10, loader.timings
    assert violations == [] and sum(g.event.records for g in loader._guards) == 6
    loader.close()


def test_an_unrecorded_batch_holds_its_slot(tmp_path, monkeypatch):
    """Batch 2 (slot 0 again) waits while batch 0 is unrecorded, whatever
    the time; once recorded, it waits for that copy to complete (0.2 s on
    the stand-in's clock) and then lands in slot 0; batch 0 was intact
    until its record."""
    csv_path, bags = _write_bag_cohort(str(tmp_path), 11, 16, disk="bfloat16")
    loader, violations = _guarded_cpu_loader(csv_path, bags, monkeypatch, copy_s=0.2)
    want = [_ragged_snapshot(b) for b in JN.NativeRaggedLoader(csv_path, bags, STAINS, **RAGGED)]
    batches = iter(loader)
    b0, b1 = next(batches), next(batches)
    b1["copied"].record()
    taken = {}
    worker = threading.Thread(target=lambda: taken.setdefault("b2", next(batches)), daemon=True)
    worker.start()
    worker.join(0.3)
    assert worker.is_alive()                       # slot 0 holds batch 0, unrecorded
    assert np.array_equal(_ragged_snapshot(b0)["feats"], want[0]["feats"])
    b0["copied"].record()
    worker.join(5)
    assert not worker.is_alive() and violations == []
    assert loader.timings[2]["guard_wait_ms"] > 150, loader.timings
    b2 = taken["b2"]
    assert b2["feats"].data_ptr() == loader._ring[0].data_ptr()
    assert np.array_equal(_ragged_snapshot(b2)["feats"], want[2]["feats"])
    b2["copied"].record()
    loader.close()


def test_page_locked_slot_registers_its_bytes_exactly(monkeypatch):
    """A pinned ring slot page-locks exactly its bytes through
    cudaHostRegister (a stand-in here: PyTorch's pinned allocator would
    round 10.9 GB up to 17.18 GB), zeroed first; views of it keep it, and
    once the last is gone it waits on its guard's last recorded copy and
    becomes a spare, which the next slot of its size takes; a slot of
    another size unregisters the spares first, as does `release_spare`; a
    failed registration raises."""
    import gc

    calls = []

    class CudartStub:
        def __init__(self, rc=0):
            self.rc = rc

        def cudaHostRegister(self, ptr, nbytes, flags):
            calls.append(("register", ptr, nbytes, flags))
            return self.rc

        def cudaHostUnregister(self, ptr):
            calls.append(("unregister", ptr))
            return 0

    monkeypatch.setattr(torch.cuda, "cudart", lambda: CudartStub())
    monkeypatch.setattr(D, "_SPARE", [])
    guard = D.SlotGuard(HostEvent(copy_s=0.1))
    nbytes = 3 * 5 * 7 * 16 * 2            # no power of two
    slot = D.PageLocked(nbytes, guard).tensor().view(torch.bfloat16)
    ptr = slot.data_ptr()
    assert slot.numel() * 2 == nbytes and not slot.any()
    assert calls == [("register", ptr, nbytes, 0)]
    batch = slot[:3 * 5 * 7 * 16].view(3, 5, 7, 16)
    del slot
    gc.collect()
    assert D._SPARE == []                  # a view still reads it
    guard.record()
    t0 = time.perf_counter()
    del batch
    gc.collect()
    assert time.perf_counter() - t0 > 0.05 and [b.data_ptr() for b in D._SPARE] == [ptr]
    again = D.PageLocked(nbytes).tensor()
    assert again.data_ptr() == ptr and len(calls) == 1 and D._SPARE == []
    del again
    gc.collect()
    other = D.PageLocked(64).tensor()
    assert calls[1] == ("unregister", ptr) and calls[2][2] == 64
    del other
    gc.collect()
    assert D.release_spare() == 64 and calls[-1][0] == "unregister" and D._SPARE == []
    monkeypatch.setattr(torch.cuda, "cudart", lambda: CudartStub(rc=2))
    with pytest.raises(RuntimeError, match="cudaHostRegister of 64 bytes failed"):
        D.PageLocked(64)
    assert D._SPARE == []
