"""Summarise the port's own trace: per-step device time by kernel (the
counterpart of `scripts/profile_summary.py`, which reads a JAX trace).

    python -m madeleine_torch.cli.pretrain ... --profile_dir /tmp/prof
    python -m madeleine_torch.tools.profile_summary /tmp/prof [--top 20] [--module step_fn]

Reads the newest ``trace.json`` that `utils/profiling.trace` wrote under the
directory (a torch.profiler Chrome trace). ``--module`` matches the
``gpu_user_annotation`` ranges, the device span of a named range: the
train step runs under ``step_fn`` (`train/trainer.py::TrainStep`), the name
the JAX package's step is jitted under. It prints the first such range's
duration as the module's time a step and the number of ranges as the steps
captured, then sums the device events (``kernel``, ``gpu_memcpy``,
``gpu_memset``) by name over the steps: the total a step, the distinct
names, and the ``--top`` names with their ms a step and share, in the JAX
script's layout. A trace with no CUDA activity (a CPU run) sums its
``cpu_op`` events instead (inclusive times: a nested op counts in its
parent too) and matches ``user_annotation`` ranges, under headings that
say so.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
from typing import Dict, List, Optional, Sequence

from madeleine_torch.utils.profiling import TRACE_FILE

DEVICE_EVENTS = ("kernel", "gpu_memcpy", "gpu_memset")


def newest_trace(profile_dir: str) -> Optional[str]:
    """The newest ``trace.json`` at or under `profile_dir`, or None."""
    paths = glob.glob(os.path.join(profile_dir, "**", TRACE_FILE), recursive=True)
    return max(paths, key=os.path.getmtime) if paths else None


def short_name(name: str) -> str:
    """A kernel's function name without return type, namespaces, template
    arguments and parameters ('void wg::gemm_kernel<...>(Params)' ->
    'gemm_kernel'); a name with neither, as a copy's, stays whole."""
    base = name.replace("(anonymous namespace)::", "")
    cut = min([i for i in (base.find("("), base.find("<")) if i > 0] or [len(base)])
    head = base[:cut].strip()
    words = head.split(" ")
    if len(words) > 1 and words[0] == "void":
        head = words[-1]
    return head.split("::")[-1] or name


def aggregate(events: List[Dict], module: str = "step_fn") -> Dict:
    """A trace's events summed: ``device`` (whether it holds CUDA activity),
    ``ranges`` (the durations, µs, of the ranges matching `module`, in time
    order), ``steps`` (their count, at least 1) and ``ops`` (a Counter of
    µs by event name over the device events, or the ``cpu_op`` events of a
    trace with no CUDA activity)."""
    xs = [e for e in events if e.get("ph") == "X"]
    device = any(e.get("cat") in DEVICE_EVENTS for e in xs)
    range_cat, op_cats = (("gpu_user_annotation", DEVICE_EVENTS) if device
                          else ("user_annotation", ("cpu_op",)))
    mods = sorted((e for e in xs if e.get("cat") == range_cat and module in e.get("name", "")),
                  key=lambda e: e.get("ts", 0))
    ops: "collections.Counter[str]" = collections.Counter()
    for e in xs:
        if e.get("cat") in op_cats:
            ops[e["name"]] += e["dur"]
    return {"device": device, "ranges": [e["dur"] for e in mods], "steps": max(1, len(mods)),
            "ops": ops}


def summarize(events: List[Dict], module: str = "step_fn", top: int = 20) -> List[str]:
    """The summary's lines for a trace's events."""
    a = aggregate(events, module)
    n, ops = a["steps"], a["ops"]
    lines = []
    if a["ranges"]:
        what = "device" if a["device"] else "host"
        lines.append(f"{module} {what} time: {a['ranges'][0] / 1e3:.1f} ms/step"
                     f"  ({n} steps captured)")
    total = sum(ops.values())
    heading = ("total device time (kernels, copies, sets)" if a["device"]
               else "total CPU op time (no CUDA activity in the trace; nested ops inclusive)")
    lines.append(f"{heading}: {total / (n * 1e3):.1f} ms/step ({len(ops)} distinct ops)\n")
    for k, v in ops.most_common(top):
        share = 100 * v / total if total else 0.0
        lines.append(f"{v / (n * 1e3):8.2f} ms/step {share:5.1f}%  "
                     f"{short_name(k)[:46]:46s} {k[:70]}")
    return lines


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("profile_dir")
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--module", default="step_fn",
                    help="substring of the named range to report step time for")
    args = ap.parse_args(argv)

    path = newest_trace(args.profile_dir)
    if path is None:
        raise SystemExit(f"no {TRACE_FILE} under {args.profile_dir}")
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    print("\n".join(summarize(events, args.module, args.top)))


if __name__ == "__main__":
    main()
