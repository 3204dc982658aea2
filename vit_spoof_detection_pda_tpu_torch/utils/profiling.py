"""Profiling and tracing hooks (JAX ``utils/profiling.py``): a
``torch.profiler`` trace where JAX writes a ``jax.profiler`` one, named
regions, the device memory in use, and a step timer."""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Optional

log = logging.getLogger(__name__)


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
    import torch
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


def annotate(name: str):
    """Named region that shows up on the profiler timeline."""
    import torch

    return torch.profiler.record_function(name)


def device_memory_gb(device=None) -> Optional[float]:
    """Current device memory allocated by PyTorch, in GB (the reference's
    per-step ``gpu_mem``, ``torch.cuda.memory_allocated()``); None off the
    card."""
    import torch

    if not torch.cuda.is_available():
        return None
    return float(torch.cuda.memory_allocated(device)) / 1e9


class StepTimer:
    """Rolling step timer: feeds steps/sec into the metric stream without
    device syncs (wall-clock between host-side step submissions)."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times = []
        self._last = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now
        if self._times:
            return len(self._times) / sum(self._times)
        return None
