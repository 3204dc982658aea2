"""Profiling and tracing hooks (JAX ``utils/profiling.py``): a
``torch.profiler`` trace where JAX writes a ``jax.profiler`` one, the
port's spans, and the device memory in use.

:class:`annotate` is the port's one span.  Every span adds to in-memory
totals per name (:func:`span_totals`): its count, its host seconds, and
its self seconds, the host seconds less the part that child spans on the
same thread cover.  While ``torch.profiler`` records, a span also opens
a ``record_function`` of its name, so it lands in the Chrome trace on
the profiler's clock beside the kernels it launched.  The port's span
names start with ``vsd.``.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from typing import Optional

import torch

log = logging.getLogger(__name__)

_lock = threading.Lock()
_totals: dict = {}                  # name -> [count, host ns, self ns]
_local = threading.local()          # .open: the child ns of each open span


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """Capture a ``torch.profiler`` trace of the CPU and, where there is a
    card, of CUDA, written into ``log_dir`` as a Chrome trace
    (``trace.json``, viewable in chrome://tracing or Perfetto).

    No-op when log_dir is falsy, so callers can pass
    ``config.telemetry.profile_dir`` straight through.
    """
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    log.info("profiler trace started -> %s", log_dir)
    try:
        yield
    finally:
        prof.stop()
        path = os.path.join(log_dir, "trace.json")
        prof.export_chrome_trace(path)
        log.info("profiler trace written to %s", path)


class annotate:
    """``with annotate("vsd.<layer>.<part>"):`` a span around a region of
    the port.  Off the profiler it costs two ``perf_counter_ns`` reads and
    a locked update of the totals; under the profiler it also opens a
    ``record_function(name, args)``.  A no-op while a program is exported
    or compiled, so frozen programs trace as without it."""

    __slots__ = ("name", "args", "_t0", "_rf")

    def __init__(self, name: str, args: Optional[str] = None):
        self.name, self.args = name, args
        self._t0 = self._rf = None

    def __enter__(self):
        if torch.compiler.is_exporting() or torch.compiler.is_compiling():
            return self
        stack = getattr(_local, "open", None)
        if stack is None:
            stack = _local.open = []
        stack.append(0)
        if torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(self.name, self.args)
            self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self._t0 is None:
            return False
        dt = time.perf_counter_ns() - self._t0
        self._t0 = None
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        stack = _local.open
        child = stack.pop()
        if stack:
            stack[-1] += dt
        with _lock:
            t = _totals.get(self.name)
            if t is None:
                t = _totals[self.name] = [0, 0, 0]
            t[0] += 1
            t[1] += dt
            t[2] += dt - child
        return False


def span_totals(reset: bool = False) -> dict:
    """``{name: {"count", "host_s", "self_s"}}`` of every span closed in
    this process (since the last reset); ``reset`` zeroes them after
    reading."""
    with _lock:
        out = {name: {"count": n, "host_s": host * 1e-9,
                      "self_s": own * 1e-9}
               for name, (n, host, own) in _totals.items()}
        if reset:
            _totals.clear()
    return out


def device_memory_gb(device=None) -> Optional[float]:
    """Current device memory allocated by PyTorch, in GB (the reference's
    per-step ``gpu_mem``, ``torch.cuda.memory_allocated()``); None off the
    card."""
    if not torch.cuda.is_available():
        return None
    return float(torch.cuda.memory_allocated(device)) / 1e9
