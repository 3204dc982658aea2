"""Device-time tables from a ``torch.profiler`` trace (the port's
counterpart of the JAX package's ``analysis/xprof.py``, which reads a
``jax.profiler`` xplane through TensorBoard's profile plugin).

The traces are the Chrome traces ``utils/profiling.py::profile_trace``
writes (``trace.json``; ``benchmark --profile DIR``, the Trainer's
``telemetry.profile_dir``), or any ``*trace.json`` under the directory.
The device's events are those of category ``kernel``, ``gpu_memcpy`` and
``gpu_memset``, each a span with its duration; a CPU-only capture has
none.  :func:`summarize_trace` keeps the JAX keys
where a Chrome trace gives the same quantity: ``n_ops`` (distinct device
op names), ``total_device_ms``, ``per_step``, ``by_category`` and
``top_ops`` (each op's ``op``, ``category``, ``execs`` and ``ms``).  The
JAX summary's ``bound_by`` comes from the TPU roofline tool and each op's
``source`` from the HLO's source line; a Chrome trace has neither, so the
port reports neither.
"""

from __future__ import annotations

import collections
import glob
import json
import os
from typing import Optional

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def find_traces(trace_dir: str) -> list:
    """The Chrome traces under ``trace_dir``, sorted."""
    return sorted(glob.glob(os.path.join(trace_dir, "**", "*trace.json"),
                            recursive=True))


def load_trace(path: str) -> list:
    """A Chrome trace's events."""
    with open(path) as f:
        return json.load(f)["traceEvents"]


def device_events(events) -> list:
    """The complete (``ph`` "X") device spans of ``events``."""
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") in DEVICE_CATEGORIES and "dur" in e]


def summarize_trace(trace_dir: str, *, top: int = 25,
                    steps: Optional[int] = None) -> dict:
    """Sum the device spans of the traces under ``trace_dir`` by category
    and by name: ``{"trace_files", "n_ops", "total_device_ms", "per_step",
    "by_category", "top_ops"}``.  ``steps`` divides every time into
    per-step time (the traced execution count, e.g. the benchmark's
    iterations); otherwise the totals over the whole capture."""
    files = find_traces(trace_dir)
    if not files:
        raise FileNotFoundError(f"no *trace.json under {trace_dir}")
    div = float(steps or 1)
    by_cat = collections.Counter()
    agg = collections.defaultdict(lambda: {"time_us": 0.0, "execs": 0,
                                           "category": ""})
    for path in files:
        for e in device_events(load_trace(path)):
            dur = float(e["dur"])
            by_cat[e["cat"]] += dur
            a = agg[e.get("name", "")]
            a["time_us"] += dur
            a["execs"] += 1
            a["category"] = e["cat"]
    total = sum(by_cat.values())
    top_ops = [
        {"op": name, "category": v["category"], "execs": v["execs"],
         "ms": v["time_us"] / 1e3 / div}
        for name, v in sorted(agg.items(),
                              key=lambda kv: -kv[1]["time_us"])[:top]]
    return {
        "trace_files": files,
        "n_ops": len(agg),
        "total_device_ms": total / 1e3 / div,
        "per_step": steps is not None,
        "by_category": [
            {"category": c, "ms": t / 1e3 / div,
             "percent": (100.0 * t / total) if total else 0.0}
            for c, t in by_cat.most_common()],
        "top_ops": top_ops,
    }


def print_summary(summary: dict) -> None:
    unit = "ms/step" if summary["per_step"] else "ms total"
    print(f"{len(summary['trace_files'])} trace file(s), "
          f"{summary['n_ops']} device ops, device time "
          f"{summary['total_device_ms']:.3f} {unit}")
    print("\n-- by category:")
    for r in summary["by_category"]:
        print(f"  {r['category']:34s} {r['ms']:9.3f} {unit:8s} "
              f"{r['percent']:5.1f}%")
    print(f"\n-- top {len(summary['top_ops'])} ops:")
    for r in summary["top_ops"]:
        print(f"  {r['ms']:9.3f} {unit:8s} x{r['execs']:<5d} "
              f"{r['category'][:12]:12s} {r['op'][:90]}")
    if not summary["by_category"]:
        print("\n(no device events — a CPU-only capture?)")
