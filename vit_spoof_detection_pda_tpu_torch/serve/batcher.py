"""Cross-request micro-batching scheduler for the serving programs (the
port's copy of the JAX package's ``serve/batcher.py``; numpy and threads
only).

A batch of images costs the card little more than one image, so the
MicroBatcher turns concurrent single-image requests into device
batches: the dispatcher holds the first request of a window for at most
``max_wait_ms`` while co-riders accumulate, splits the group across the
supported batch shapes with minimal padding (a 32-group on shapes
{1, 16, 128} runs as 16+16, not one 96-row-padded 128 dispatch —
padded rows compute and transfer like real ones), and fans the rows
back out to per-request futures.

Design notes:

- One dispatcher thread owns the device queue; request threads only
  enqueue and wait on a Future.  A single enqueuer keeps every launch on
  one thread and preserves batch ordering.
- ``programs`` maps a supported batch size to a callable
  (``uint8 [B,H,W,3] -> {"prob1": [B], "pred": [B]}``), e.g. from
  ``serve.server.build_programs_live``.
- Padding rows are zeros; their outputs are dropped before fan-out.
- Errors from the program fail every request in that batch (the
  callers see the exception re-raised from their Future).
- Each request's queue wait, from submit to the start of its batch's
  dispatch, is kept beside its latency: ``stats()["queue_wait_ms"]``.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, Dict, Mapping, Sequence

import numpy as np

log = logging.getLogger(__name__)

_SENTINEL = object()


@dataclass
class _Request:
    image: np.ndarray
    future: Future
    t_submit: float = field(default_factory=time.monotonic)


class MicroBatcher:
    """Coalesce concurrent single-image requests into device batches.

    ``programs``: {batch_size: callable} — the supported shapes.  A
    window of ``b`` requests splits across supported sizes with minimal
    padded rows (see ``_plan``; windows never exceed the largest
    size).  ``max_wait_ms`` bounds the
    extra latency the FIRST request of a window pays waiting for
    co-riders; under a saturated queue the wait never triggers (the
    next batch fills instantly).
    """

    def __init__(self, programs: Mapping[int, Callable], *,
                 img_size: int = 224, max_wait_ms: float = 2.0,
                 queue_depth: int = 1024):
        if not programs:
            raise ValueError("programs must map at least one batch size")
        sizes = sorted(int(b) for b in programs)
        if sizes[0] < 1:
            raise ValueError(f"batch sizes must be >= 1, got {sizes}")
        self._programs: Dict[int, Callable] = {
            int(b): fn for b, fn in programs.items()}
        self._sizes: Sequence[int] = sizes
        self._img_size = int(img_size)
        self._max_wait = float(max_wait_ms) / 1000.0
        self._queue: "queue.Queue" = queue.Queue(maxsize=queue_depth)
        self._closed = False
        self._plan_cache: Dict[int, Sequence[int]] = {}
        self._lock = threading.Lock()
        # orders every enqueue against close(): a submit that passed the
        # closed check has its item in the queue BEFORE the shutdown
        # sentinel, so the drain resolves it (no silently stranded
        # Futures during a hot-swap)
        self._submit_gate = threading.Lock()
        self._stats = {"requests": 0, "batches": 0, "images": 0,
                       "padded_rows": 0, "errors": 0}
        self._latencies: list = []          # bounded reservoir, ms
        self._waits: list = []              # the same requests' queue wait
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        name="pad-microbatcher",
                                        daemon=True)
        self._thread.start()

    @property
    def batch_sizes(self) -> Sequence[int]:
        return tuple(self._sizes)

    @property
    def img_size(self) -> int:
        return self._img_size

    def submit(self, image: np.ndarray) -> Future:
        """Enqueue one (H, W, 3) uint8 image; returns a Future resolving
        to ``{"prob1": float, "pred": int}``."""
        image = np.asarray(image)
        want = (self._img_size, self._img_size, 3)
        if image.shape != want or image.dtype != np.uint8:
            raise ValueError(
                f"expected uint8 {want} image, got "
                f"{image.dtype} {image.shape}")
        with self._submit_gate:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            fut: Future = Future()
            self._queue.put(_Request(image=image, future=fut))
        return fut

    def submit_many(self, frames: np.ndarray) -> list:
        """Enqueue a block of (N, H, W, 3) uint8 frames; returns one
        Future per frame (order preserved).  The dispatcher's window
        sweep coalesces consecutively queued frames into full device
        batches, so a block amortizes exactly like concurrent clients
        — without per-frame HTTP requests."""
        frames = np.asarray(frames)
        want = (self._img_size, self._img_size, 3)
        if frames.ndim != 4 or frames.shape[1:] != want \
                or frames.dtype != np.uint8:
            raise ValueError(
                f"expected uint8 (N, {want[0]}, {want[1]}, 3) block, "
                f"got {frames.dtype} {frames.shape}")
        futs = []
        with self._submit_gate:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            for i in range(frames.shape[0]):
                fut: Future = Future()
                self._queue.put(_Request(image=frames[i], future=fut))
                futs.append(fut)
        return futs

    def stats(self) -> dict:
        """Counters, latency percentiles (ms, submit -> result) and queue
        wait percentiles (ms, submit -> the start of its dispatch)."""
        with self._lock:
            out = dict(self._stats)
            lats = np.asarray(self._latencies, np.float64)
            waits = np.asarray(self._waits, np.float64)
        out["batch_sizes"] = list(self._sizes)
        out["avg_batch"] = (out["images"] / out["batches"]
                            if out["batches"] else 0.0)
        for key, ms in (("latency_ms", lats), ("queue_wait_ms", waits)):
            if ms.size:
                out[key] = {
                    "p50": round(float(np.percentile(ms, 50)), 3),
                    "p95": round(float(np.percentile(ms, 95)), 3),
                    "p99": round(float(np.percentile(ms, 99)), 3),
                    "max": round(float(ms.max()), 3)}
        return out

    def warmup(self, timeout: float = 600.0):
        """Run every supported shape once on a zero batch, THROUGH the
        dispatcher (an exact-fit block always plans as one unsplit
        dispatch), so first real requests don't pay first-dispatch
        latency (kernel builds, allocator growth)."""
        for size in self._sizes:
            frames = np.zeros((size, self._img_size, self._img_size, 3),
                              np.uint8)
            for f in self.submit_many(frames):
                f.result(timeout=timeout)

    def close(self, timeout: float = 10.0):
        """Stop accepting work, drain the queue, join the dispatcher."""
        with self._submit_gate:
            if self._closed:
                return
            self._closed = True
            self._queue.put(_SENTINEL)
        self._thread.join(timeout=timeout)

    # -- dispatcher ----------------------------------------------------

    def _plan(self, b: int) -> Sequence[int]:
        """Decompose a ``b``-request group into supported dispatch sizes
        minimizing (padded rows, dispatch count) lexicographically.

        Padded rows are pure waste — they compute and transfer like real
        rows.  So a 32-group on shapes {1, 16, 128} runs as 16+16, and a
        17-group as 16+1, instead of one 111-row-padded 128 dispatch.
        """
        cached = self._plan_cache.get(b)
        if cached is not None:
            return cached
        # dp[k] = (padded, dispatches, size_of_last_dispatch) for k items
        dp = [(0, 0, 0)] * (b + 1)
        for k in range(1, b + 1):
            best = None
            for s in self._sizes:
                if s >= k:
                    # terminal dispatch: smallest s >= k pads least
                    cand = (s - k, 1, s)
                    if best is None or cand[:2] < best[:2]:
                        best = cand
                    break
                prev = dp[k - s]
                cand = (prev[0], prev[1] + 1, s)
                if best is None or cand[:2] < best[:2]:
                    best = cand
            dp[k] = best
        plan, k = [], b
        while k > 0:
            s = dp[k][2]
            plan.append(s)
            k -= min(s, k)
        # larger dispatches first: the bulk of the window resolves on
        # the first device call
        plan = tuple(sorted(plan, reverse=True))
        self._plan_cache[b] = plan
        return plan

    def _collect_window(self):
        """Block for the first request, then gather co-riders until the
        window closes or the largest supported batch fills.  Returns the
        group (possibly empty on shutdown)."""
        items = []
        while True:
            first = self._queue.get()
            if first is _SENTINEL:
                return items, True
            items.append(first)
            break
        deadline = time.monotonic() + self._max_wait
        max_b = self._sizes[-1]
        while len(items) < max_b:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                # past the window: keep sweeping whatever is already
                # queued (no extra waiting), stop at the first gap
                try:
                    nxt = self._queue.get_nowait()
                except queue.Empty:
                    break
            else:
                try:
                    nxt = self._queue.get(timeout=timeout)
                except queue.Empty:
                    break
            if nxt is _SENTINEL:
                return items, True
            items.append(nxt)
        return items, False

    def _dispatch_loop(self):
        while True:
            items, shutdown = self._collect_window()
            if items:
                self._run_batch(items)
            if shutdown:
                # drain anything that raced in behind the sentinel
                leftovers = []
                while True:
                    try:
                        it = self._queue.get_nowait()
                    except queue.Empty:
                        break
                    if it is not _SENTINEL:
                        leftovers.append(it)
                if leftovers:
                    self._run_batch(leftovers)
                return

    def _run_batch(self, items):
        """Dispatch a collected window, split per the zero-pad plan;
        each dispatch fans its rows out (and isolates its errors)
        independently."""
        offset = 0
        for size in self._plan(len(items)):
            group = items[offset:offset + size]
            offset += len(group)
            self._dispatch(group, size)

    def _dispatch(self, items, target):
        start = time.monotonic()
        b = len(items)
        batch = np.zeros((target, self._img_size, self._img_size, 3),
                         np.uint8)
        for i, it in enumerate(items):
            batch[i] = it.image
        try:
            out = self._programs[target](batch)
            prob1 = np.asarray(out["prob1"], np.float32)
            pred = np.asarray(out["pred"], np.int32)
        except Exception as e:                   # noqa: BLE001
            log.exception("serving program failed on a %d-batch", target)
            with self._lock:
                self._stats["errors"] += b
            for it in items:
                if not it.future.cancelled():
                    it.future.set_exception(e)
            return
        now = time.monotonic()
        for i, it in enumerate(items):
            if not it.future.cancelled():
                it.future.set_result(
                    {"prob1": float(prob1[i]), "pred": int(pred[i])})
        with self._lock:
            self._stats["requests"] += b
            self._stats["batches"] += 1
            self._stats["images"] += b
            self._stats["padded_rows"] += target - b
            for it in items:
                self._latencies.append((now - it.t_submit) * 1000.0)
                self._waits.append((start - it.t_submit) * 1000.0)
            if len(self._latencies) > 4096:
                del self._latencies[:len(self._latencies) - 2048]
                del self._waits[:len(self._waits) - 2048]
