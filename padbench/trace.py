"""Reading a ``torch.profiler`` Chrome trace: device time by kernel name,
the device's busy and idle time over a traced window, the idle gaps
labelled by what the host was doing, and device time per call of a
Python function of the program.

The device-event reader follows ``analysis/xprof.py`` of the program (a
copy, so that the yardstick stays put when the program changes): the
device's events are the complete (``ph`` "X") spans of category
``kernel``, ``gpu_memcpy`` and ``gpu_memset``.  Times in a Chrome trace
are microseconds; everything returned here is in seconds.
"""

from __future__ import annotations

import bisect
import collections
import json
import re

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime",
                   "cuda_driver", "python_function")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")


def load(path) -> list:
    """A Chrome trace's events."""
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _spans(events, categories) -> list:
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") in categories and "dur" in e]


def device_events(events) -> list:
    """The complete device spans of ``events``."""
    return _spans(events, DEVICE_CATEGORIES)


def window_of(events, name: str) -> tuple:
    """``(start, end)`` in microseconds of the host span ``name`` (a
    ``record_function`` the benchmark opened around the traced stretch);
    None if the trace holds no such span."""
    for e in _spans(events, ("user_annotation",)):
        if e.get("name") == name:
            return float(e["ts"]), float(e["ts"]) + float(e["dur"])
    return None


def union_length(intervals) -> float:
    """The length covered by a list of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, t0: float, t1: float) -> list:
    """The ``(start, length)`` stretches of ``[t0, t1]`` that no interval
    covers."""
    gaps, cursor = [], t0
    for s, e in sorted(intervals):
        if s > cursor:
            gaps.append((cursor, s - cursor))
        cursor = max(cursor, e)
    if t1 > cursor:
        gaps.append((cursor, t1 - cursor))
    return gaps


class _HostIndex:
    """The host's spans, per thread, to ask which were open at a time."""

    def __init__(self, events):
        self.by_tid = collections.defaultdict(list)
        for e in _spans(events, HOST_CATEGORIES):
            self.by_tid[e.get("tid")].append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                 e.get("cat"), e.get("name", "")))
        for lst in self.by_tid.values():
            lst.sort()
        self.starts = {t: [s for s, *_ in v] for t, v in self.by_tid.items()}

    def open_at(self, t: float) -> list:
        """Every host span open at ``t``, outermost first."""
        out = []
        for tid, lst in self.by_tid.items():
            i = bisect.bisect_right(self.starts[tid], t)
            out += [x for x in lst[:i] if x[1] > t]
        return sorted(out, key=lambda x: (x[0], -x[1]))


def gap_label(open_spans, prefix: str) -> str:
    """``<innermost benchmark span>/<innermost other host event>``: the
    benchmark's own ``record_function`` (names starting ``prefix``) that
    was open, and what the host was inside of."""
    ours = [n for _, _, c, n in open_spans
            if c == "user_annotation" and n.startswith(prefix)]
    other = [n for _, _, c, n in open_spans
             if not (c == "user_annotation" and n.startswith(prefix))
             and c != "python_function"]
    return f"{ours[-1] if ours else '-'}/{other[-1] if other else '-'}"


def summarize(events, *, window: str, prefix: str = "padbench.",
              top: int = 10) -> dict:
    """What the traced stretch shows, over the host span ``window``:

    - ``window_s``: its length; ``busy_s``: the time in it in which a
      kernel, a copy or a memset ran on the device (the union of their
      spans); ``idle_s`` the rest;
    - ``kernels``: ``{name: [seconds, launches]}`` of the device's
      kernels that started in it; ``memcpy``: ``[(name, bytes,
      seconds)]`` of its copies;
    - ``spans``: ``{name: count}`` of the benchmark's spans that started
      in it;
    - ``device_ops``: the ``top`` device operations by time;
      ``idle_gaps``: the ``top`` longest idle gaps, each labelled by
      :func:`gap_label` at its start.

    None when the trace holds no ``window`` span."""
    win = window_of(events, window)
    if win is None:
        return None
    t0, t1 = win
    dev = [e for e in device_events(events) if t0 <= float(e["ts"]) < t1]
    intervals = [(float(e["ts"]), min(float(e["ts"]) + float(e["dur"]), t1))
                 for e in dev]
    busy = union_length(intervals)
    kernels = collections.defaultdict(lambda: [0.0, 0])
    memcpy = []
    for e in dev:
        if e["cat"] == "kernel":
            k = kernels[e.get("name", "")]
            k[0] += float(e["dur"]) * 1e-6
            k[1] += 1
        elif e["cat"] == "gpu_memcpy":
            memcpy.append((e.get("name", ""),
                           int((e.get("args") or {}).get("bytes", 0)),
                           float(e["dur"]) * 1e-6))
    by_op = collections.Counter()
    for e in dev:
        by_op[e.get("name", "")] += float(e["dur"]) * 1e-6
    spans = collections.Counter(
        e.get("name", "") for e in _spans(events, ("user_annotation",))
        if t0 <= float(e["ts"]) < t1
        and e.get("name", "").startswith(prefix))
    gaps = sorted(idle_gaps(intervals, t0, t1), key=lambda g: -g[1])[:top]
    host = _HostIndex(events)
    return {
        "window_s": (t1 - t0) * 1e-6,
        "busy_s": busy * 1e-6,
        "idle_s": (t1 - t0 - busy) * 1e-6,
        "kernels": {k: list(v) for k, v in kernels.items()},
        "memcpy": memcpy,
        "spans": dict(spans),
        "device_ops": [[n, s] for n, s in by_op.most_common(top)],
        "idle_gaps": [[gap_label(host.open_at(s + 1e-3), prefix), g * 1e-6]
                      for s, g in gaps],
    }


def kernel_time(summary, pattern: str) -> tuple:
    """``(seconds, launches)`` of the kernels whose name matches the
    regular expression ``pattern``."""
    rx = re.compile(pattern)
    s = n = 0
    for name, (sec, count) in summary["kernels"].items():
        if rx.search(name):
            s += sec
            n += count
    return s, n


def call_device_times(events, functions) -> dict:
    """Device time per call of Python functions of the program, from a
    trace taken with ``with_stack=True`` (its ``python_function``
    events): ``{function: [seconds of each call]}``.  A function is named
    ``"<path suffix>:<name>"`` (``"ops/attention.py:fused_mlp_block"``).
    A call's time is the sum of the kernels whose launch (linked by the
    trace's ``correlation``) the host made inside that call; calls that
    launched no kernel the trace caught are left out."""
    want = {}
    for f in functions:
        path, name = f.rsplit(":", 1)
        want[f] = (path + "(", ": " + name)
    py = collections.defaultdict(list)
    for e in _spans(events, ("python_function",)):
        n = e.get("name", "")
        for f, (path, tail) in want.items():
            if path in n and n.endswith(tail):
                py[e.get("tid")].append(
                    (float(e["ts"]), float(e["ts"]) + float(e["dur"]), f,
                     id(e)))
    for lst in py.values():
        lst.sort()
    starts = {t: [s for s, *_ in v] for t, v in py.items()}
    call_of = {}                   # correlation -> [(function, call id)]
    for e in _spans(events, LAUNCH_CATEGORIES):
        corr = (e.get("args") or {}).get("correlation")
        tid = e.get("tid")
        if corr is None or tid not in py:
            continue
        t = float(e["ts"])
        i = bisect.bisect_right(starts[tid], t)
        hits = [(f, cid) for s, end, f, cid in py[tid][:i] if end > t]
        if hits:
            call_of[corr] = hits
    per_call = collections.defaultdict(float)
    for e in _spans(events, ("kernel",)):
        corr = (e.get("args") or {}).get("correlation")
        for f, cid in call_of.get(corr, ()):
            per_call[(f, cid)] += float(e["dur"]) * 1e-6
    out = {f: [] for f in functions}
    for (f, _), sec in sorted(per_call.items(), key=lambda kv: kv[0][1]):
        out[f].append(sec)
    return out
