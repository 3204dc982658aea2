"""The program's own spans in a traced stretch, and the readers of the
metrics that read them.

The port opens its spans with ``utils/profiling.py::annotate``: names
that start with ``vsd.``, ``record_function`` events (category
``user_annotation``) in the Chrome trace while the profiler records, and
totals per name in memory always (``span_totals()``).  Over the stretch
between the bounds of the benchmark's window span:

- ``n`` and ``host_s``: a span's count and its duration, clipped to the
  stretch;
- ``device_s``: the kernels, copies and memsets that started in the
  stretch and whose launch (found through the trace's ``correlation``)
  the host made inside the span: the innermost ``vsd.`` span open at the
  launch on the launching thread, else the innermost open on any thread
  (autograd's engine thread launches the backward while the main thread
  waits inside ``vsd.train.backward``);
- ``idle_s``: each instant of each idle gap of the device goes to the
  innermost ``vsd.`` span open on any host thread at that instant, and
  to ``"-"`` where none is.  The ``idle_s`` values sum to the stretch's
  ``idle_s`` (``trace.summarize``).

"Innermost" is the open span that started last (of two that started
together, the shorter).

The spans are host events outside the ``padbench.`` prefix, so the
labels of ``trace.summarize``'s ``idle_gaps`` name the program span the
host was in where it was in no operator.  ``kernel_load_s`` and
``program_build_s`` read the program's totals (:func:`span_total_s`) and
need nothing of the trace.  :func:`span_idle_pct` and
:func:`span_device_ms` read ``summary["program"]``, which
``trace.summarize`` does not give yet: one added entry in its result,
``"program": spans.summarize(events, window=window)``, lets a
``metrics/<name>.py`` call them.  Until then they return None.

A metric that reads a new span: open it in the program with
``annotate("vsd.<layer>.<part>")``, then read it here with
:func:`span_idle_pct`, :func:`span_device_ms` or :func:`span_total_s`.
"""

from __future__ import annotations

import bisect
import collections

from . import readers, trace

PREFIX = "vsd."
OUTSIDE = "-"              # the key of what no program span covers


def _program_spans(events, prefix: str) -> list:
    """``(start, end, name, tid)`` of the program's spans, by start."""
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e.get("name", ""), e.get("tid"))
                  for e in trace._spans(events, ("user_annotation",))
                  if e.get("name", "").startswith(prefix))


class _Innermost:
    """The innermost span open at each instant, over a set of spans: the
    pieces of their union, each with one name."""

    def __init__(self, spans):
        points = sorted({s for s, *_ in spans} | {e for _, e, *_ in spans})
        order = sorted(spans, key=lambda x: (x[0], -x[1]))
        self.pieces, active, j = [], [], 0
        for a, b in zip(points, points[1:]):
            while j < len(order) and order[j][0] <= a:
                active.append(order[j])
                j += 1
            active = [x for x in active if x[1] > a]
            if active:
                top = max(active, key=lambda x: (x[0], -x[1]))
                self.pieces.append((a, b, top[2]))
        self.starts = [a for a, _, _ in self.pieces]

    def at(self, t: float):
        """The name of the innermost span open at ``t``; None if none."""
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.pieces[i][1] > t:
            return self.pieces[i][2]
        return None

    def split(self, t0: float, t1: float) -> dict:
        """``{name: length}`` of ``[t0, t1]`` by innermost span, the part
        no span covers under :data:`OUTSIDE`."""
        out = collections.defaultdict(float)
        i = max(bisect.bisect_right(self.starts, t0) - 1, 0)
        covered = 0.0
        while i < len(self.pieces) and self.pieces[i][0] < t1:
            a, b, name = self.pieces[i]
            part = min(b, t1) - max(a, t0)
            if part > 0:
                out[name] += part
                covered += part
            i += 1
        if t1 - t0 > covered:
            out[OUTSIDE] += t1 - t0 - covered
        return out


def summarize(events, *, window: str, prefix: str = PREFIX) -> dict:
    """``{span: {"n", "host_s", "device_s", "idle_s"}}`` of every program
    span open in the host span ``window``, plus :data:`OUTSIDE` (the
    module docstring); None when the trace holds no ``window`` span."""
    win = trace.window_of(events, window)
    if win is None:
        return None
    t0, t1 = win
    spans = _program_spans(events, prefix)
    out = collections.defaultdict(lambda: {"n": 0, "host_s": 0.0,
                                           "device_s": 0.0, "idle_s": 0.0})
    out[OUTSIDE]                   # reported whether or not it holds time
    for s, e, name, _ in spans:
        if e > t0 and s < t1:
            out[name]["n"] += 1
            out[name]["host_s"] += (min(e, t1) - max(s, t0)) * 1e-6
    anywhere = _Innermost(spans)
    by_tid = collections.defaultdict(list)
    for x in spans:
        by_tid[x[3]].append(x)
    on_tid = {tid: _Innermost(v) for tid, v in by_tid.items()}
    launch = {}
    for e in trace._spans(events, trace.LAUNCH_CATEGORIES):
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None:
            launch[corr] = (float(e["ts"]), e.get("tid"))
    dev = [e for e in trace.device_events(events)
           if t0 <= float(e["ts"]) < t1]
    for e in dev:
        name = None
        hit = launch.get((e.get("args") or {}).get("correlation"))
        if hit is not None:
            t, tid = hit
            if tid in on_tid:
                name = on_tid[tid].at(t)
            if name is None:
                name = anywhere.at(t)
        out[name or OUTSIDE]["device_s"] += float(e["dur"]) * 1e-6
    intervals = [(float(e["ts"]), min(float(e["ts"]) + float(e["dur"]), t1))
                 for e in dev]
    for g0, length in trace.idle_gaps(intervals, t0, t1):
        for name, part in anywhere.split(g0, g0 + length).items():
            out[name]["idle_s"] += part * 1e-6
    return dict(out)


def _program(ctx):
    return (ctx.summary or {}).get("program") or None


def span_idle_pct(ctx, names):
    """The share of the traced stretch in which the device was idle while
    the innermost program span open was one of ``names``; None where the
    stretch holds none of them."""
    prog = _program(ctx)
    if prog is None or not ctx.summary["window_s"] > 0:
        return None
    hits = [prog[n]["idle_s"] for n in names if n in prog]
    if not hits:
        return None
    return 100.0 * sum(hits) / ctx.summary["window_s"]


def span_device_ms(ctx, names, unit: str):
    """Device time launched inside the spans ``names``, per benchmark
    ``unit`` (``"batch"``, ``"step"``); None where the stretch holds none
    of them."""
    prog = _program(ctx)
    n = readers.units(ctx, unit)
    if prog is None or n is None:
        return None
    hits = [prog[x]["device_s"] for x in names if x in prog]
    if not hits:
        return None
    return 1e3 * sum(hits) / n


def span_total_s(prefix: str):
    """Seconds this process spent in the program's spans whose names
    start with ``prefix``, from its in-memory totals: each span's self
    time, so a second in a span nested in another counts once, under the
    inner one (a ``vsd.kernels.load`` inside a ``vsd.build.*`` under the
    load).  None where the program keeps no totals or no such span
    closed."""
    from vit_spoof_detection_pda_tpu_torch.utils import profiling
    totals = getattr(profiling, "span_totals", None)
    if totals is None:
        return None
    hits = [v["self_s"] for k, v in totals().items() if k.startswith(prefix)]
    return sum(hits) if hits else None
