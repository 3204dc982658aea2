"""The harness: finds a cell, its configuration, its traffic, its driver
and its metrics by the names in ``BENCHMARK.json``, runs the cell once
and assembles the result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric sits in a file of its own under the benchmark's
directory, found by name:

- ``configs/<config>.json`` (the path ``BENCHMARK.json`` gives),
- ``traffic/<traffic>.json``, read by ``generate.py``,
- ``workloads/<cell>.json``: the driver, the program's entry, the
  limits of the comparison and the program functions whose kernels the
  traced run attributes,
- ``drivers/<driver>.py``: ``run(ctx) -> dict`` builds the program,
  drives the window and compares what it produced,
- ``metrics/<metric>.py``: ``read(ctx) -> float | None`` takes one
  per-layer metric from the traced run.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

SPAN = "padbench."          # the prefix of the benchmark's own spans
WINDOW_SPAN = SPAN + "window"
TRACE_START_S = 3.0         # stretch A starts this far into the window
TRACE_STRETCH_S = 2.0       # and lasts this long
ATTRIBUTE_UNITS = 3         # units (batches, steps) stretch B records


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Manifest:
    """``BENCHMARK.json`` at ``root`` and the files it names."""

    def __init__(self, root):
        self.root = Path(root)
        self.bench = load_json(self.root / "BENCHMARK.json")
        self.dir = self.root / self.bench["paths"][0]
        self.configs = {c["name"]: c for c in self.bench["configs"]}
        self.cells = {w["name"]: w for w in self.bench["workloads"]}

    def config(self, name: str) -> dict:
        return load_json(self.root / self.configs[name]["file"])

    def traffic(self, name: str) -> dict:
        return load_json(self.dir / "traffic" / f"{name}.json")

    def workload(self, name: str) -> dict:
        return load_json(self.dir / "workloads" / f"{name}.json")

    def driver(self, name: str):
        return _module(self.dir / "drivers" / f"{name}.py",
                       f"padbench_driver_{name}")

    def reader(self, metric: str):
        return _module(self.dir / "metrics" / f"{metric}.py",
                       "padbench_metric_" + metric.replace(".", "_"))

    def end_to_end(self, cell: str) -> list:
        """The cell's end-to-end metrics: those that list it, and those
        that list no cells (``setup_s``)."""
        return [m for m in self.bench["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list:
        """The cell's per-layer metrics: those that list it, and those
        without a list whose ``moves`` the cell reports."""
        mine = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.bench["per_layer"]
                if ("workloads" in m and cell in m["workloads"])
                or ("workloads" not in m and m["moves"] in mine)]


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


class Tracer:
    """Profiles a bounded stretch inside the window of a traced run.

    The driver calls :meth:`open` when its window opens and :meth:`tick`
    before each unit of work (a batch, a step).  Stretch A starts
    ``TRACE_START_S`` into the window and lasts ``TRACE_STRETCH_S``: CPU
    and CUDA activity, inside the span ``padbench.window``.  Stretch B,
    right after it when the cell names program functions to
    ``attribute``, records Python calls (``with_stack=True``) for
    ``ATTRIBUTE_UNITS`` units, so that kernels can be tied to the function
    that launched them.  Nothing happens in a run without
    ``--trace 1``."""

    def __init__(self, enabled: bool, attribute: list):
        self.ta = None
        self.enabled, self.attribute = enabled, attribute
        self.state, self.t0, self.prof = "off", None, None
        self.units = 0
        self.files = {}
        self.dir = tempfile.mkdtemp(prefix="padbench-") if enabled else None
        self._span = None

    def _profile(self, stack: bool):
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts, with_stack=stack)
        prof.start()
        return prof

    def warm(self):
        """Start and stop the profiler once over a little device work
        before the window: its first start in a process (the CUDA tracer's
        set-up, seconds of it) then falls in set-up, not in the window."""
        if not self.enabled:
            return
        import torch
        x = torch.ones(1 << 20, device="cuda" if torch.cuda.is_available()
                       else "cpu")
        prof = self._profile(False)
        x.mul_(1.0)
        if x.is_cuda:
            torch.cuda.synchronize()
        prof.stop()

    def open(self):
        self.t0 = time.perf_counter()
        self.state = "wait" if self.enabled else "off"

    def tick(self):
        if self.state in ("off", "done"):
            return
        now = time.perf_counter() - self.t0
        if self.state == "wait" and now >= TRACE_START_S:
            import torch
            self.prof = self._profile(False)
            self._span = torch.profiler.record_function(WINDOW_SPAN)
            self._span.__enter__()
            self.state, self.ta = "A", time.perf_counter() - self.t0
        elif self.state == "A" and now - self.ta >= TRACE_STRETCH_S:
            self._end_a()
        elif self.state == "B":
            self.units += 1
            if self.units > ATTRIBUTE_UNITS:
                self._stop("B")

    def _end_a(self):
        self._span.__exit__(None, None, None)
        self._span = None
        self._stop("A")
        if self.attribute:
            self.prof = self._profile(True)
            self.state, self.units = "B", 0
        else:
            self.state = "done"

    def _stop(self, name):
        """Stop a stretch and write its trace at once: written after the
        window, the score cell's stretch A came back with every device
        event at time 0 and duration 0."""
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()
        self.files[name] = os.path.join(self.dir, f"{name}.json")
        self.prof.export_chrome_trace(self.files[name])
        self.prof = None
        self.state = "done" if name == "B" else self.state

    def close(self):
        """End whatever stretch is open (the window has closed)."""
        if self.state == "A":
            self._end_a()
        if self.state == "B":
            self._stop("B")
        self.state = "done" if self.enabled else "off"

    def read(self) -> tuple:
        """``(summary of stretch A, {function: [device s a call]})`` after
        :meth:`close`; the trace files are removed."""
        from . import trace
        summary, calls = None, {}
        try:
            for name, path in self.files.items():
                events = trace.load(path)
                if name == "A":
                    summary = trace.summarize(events, window=WINDOW_SPAN,
                                              prefix=SPAN)
                else:
                    calls = trace.call_device_times(events, self.attribute)
        finally:
            shutil.rmtree(self.dir, ignore_errors=True)
        return summary, calls


class Context:
    """What a driver and a metric reader see of a run."""

    def __init__(self, manifest: Manifest, cell: str, *, seed: int,
                 seconds: float, trace: bool, device, t_start: float):
        entry = manifest.cells[cell]
        self.config = manifest.config(entry["config"])
        self.traffic = manifest.traffic(entry["traffic"])
        self.workload = manifest.workload(cell)
        self.seed, self.seconds, self.trace = int(seed), float(seconds), trace
        self.device = device
        self.t_start = t_start
        self.setup_s = None
        self.memory_peak_bytes = 0
        self.tracer = Tracer(trace, self.workload.get("attribute", []))
        self.summary, self.calls = None, {}

    def setup_done(self):
        """Set-up ends here: the program is built and warm; the window
        opens next."""
        import torch
        self.tracer.warm()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.setup_s = time.perf_counter() - self.t_start
        log(f"setup_s {self.setup_s:.3f}")

    def window_closed(self):
        """The window has closed: stop the tracer, read the device's peak
        memory (before anything else allocates)."""
        import torch
        self.tracer.close()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated())


def run_cell(manifest: Manifest, cell: str, *, seed: int, seconds: float,
             trace: bool, device, t_start: float) -> dict:
    """Run one cell once; the result line's fields."""
    ctx = Context(manifest, cell, seed=seed, seconds=seconds, trace=trace,
                  device=device, t_start=t_start)
    driver = manifest.driver(ctx.workload["driver"])
    out = driver.run(ctx)
    checks = out["checks"]
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    if not trace:
        vals = dict(out["e2e"], setup_s=ctx.setup_s)
        for m in manifest.end_to_end(cell):
            metrics[m["name"]] = {"value": vals[m["name"]], "unit": m["unit"]}
    else:
        ctx.summary, ctx.calls = ctx.tracer.read()
        for m in manifest.per_layer(cell):
            v = manifest.reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": device_info(device, ctx)}
    if trace and ctx.summary is not None:
        result["breakdown"] = {"device_ops": ctx.summary["device_ops"],
                               "idle_gaps": ctx.summary["idle_gaps"]}
    result["_readings"] = out.get("readings", {})
    result["checks"] = checks
    return result


def device_info(device, ctx) -> dict:
    import torch
    if device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1}
    info["memory_peak_bytes"] = ctx.memory_peak_bytes
    if ctx.trace and ctx.summary is not None:
        info["busy_s"] = ctx.summary["busy_s"]
        info["window_s"] = ctx.summary["window_s"]
    return info


def check(value: float, limit: float) -> dict:
    return {"value": float(value), "limit": float(limit)}
