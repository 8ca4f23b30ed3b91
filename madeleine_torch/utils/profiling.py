"""Profiling utilities: torch.profiler traces, named ranges and step timing
(JAX: madeleine_tpu/utils/profiling.py, on jax.profiler).

- `trace(log_dir)`: a torch.profiler window over the block, CPU activity and,
  where CUDA is available, CUDA activity; it writes a Chrome trace,
  ``<log_dir>/trace.json``. Nothing happens when log_dir is None.
- `annotate(name)`: a named range (``record_function``); under a CUDA
  trace it also spans the GPU work its launches enqueue.
- `StepTimer`: rolling wall-clock step statistics, skipping warm-up steps.
- `module_device_ms(profile_dir, name)`: the median device duration of a
  named range in such a trace.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import statistics
import time
from typing import Dict, List, Optional

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Profile the block into ``<log_dir>/trace.json`` (no-op when log_dir is None)."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """Named range for trace attribution."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Rolling wall-clock step statistics (skips warmup steps)."""

    def __init__(self, skip_first: int = 2):
        self.skip_first = skip_first
        self._times: List[float] = []
        self._t0: Optional[float] = None
        self._seen = 0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, sync: Optional[torch.Tensor] = None) -> float:
        """Pass a tensor as `sync` to wait for its device's work first."""
        if sync is not None and sync.device.type == "cuda":
            torch.cuda.synchronize(sync.device)
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        self._seen += 1
        if self._seen > self.skip_first:
            self._times.append(dt)
        return dt

    def stats(self) -> Dict[str, float]:
        if not self._times:
            return {"steps": 0}
        import numpy as np

        arr = np.asarray(self._times)
        return {
            "steps": len(arr),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
            "total_s": float(arr.sum()),
        }


def module_device_ms(profile_dir: str, name: str = "step_fn") -> Optional[float]:
    """Median device duration (ms) of the GPU ranges (``gpu_user_annotation``
    events) whose name contains `name`, in the newest Chrome trace
    (``*.json``) under `profile_dir`. None when there is no trace or no
    match."""
    paths = sorted(glob.glob(os.path.join(profile_dir, "*.json")), key=os.path.getmtime)
    if not paths:
        return None
    with open(paths[-1]) as f:
        events = json.load(f).get("traceEvents", [])
    durs = [e["dur"] for e in events if e.get("ph") == "X"
            and e.get("cat") == "gpu_user_annotation" and name in e.get("name", "")]
    if not durs:
        return None
    return statistics.median(durs) / 1e3
