"""The arithmetic of the per-layer metrics.  Each metric's own file under
``metrics/`` names what it reads and calls one of these.  A reader that
finds nothing to read returns None, and the metric is left out of the
result line; none returns 0 for a share of a peak or a roofline."""

from __future__ import annotations

import statistics

from . import trace, work

HTOD = "HtoD"


def idle_pct(ctx):
    """The share of the traced stretch in which no kernel, copy or memset
    ran on the device (nothing where the stretch holds no device event)."""
    s = ctx.summary
    if not s or s["window_s"] <= 0 or not s["busy_s"]:
        return None
    return 100.0 * s["idle_s"] / s["window_s"]


def units(ctx, span: str):
    """How many of the benchmark's ``span`` (one a batch or a step)
    started in the traced stretch; None if none did."""
    s = ctx.summary
    n = (s or {}).get("spans", {}).get("padbench." + span, 0)
    return n or None


def stretch_mfu(ctx, span: str, flops_per_unit: float):
    """The whole step's share of the configuration's peak over the traced
    stretch: the model's operations of every unit that started in it
    over the stretch's length."""
    n = units(ctx, span)
    if n is None:
        return None
    return (100.0 * n * flops_per_unit / ctx.summary["window_s"]
            / ctx.config["peak_flops"])


def roofline_by_call(ctx, function: str, kernel: str, b: int):
    """``kernel``'s bound (``work.KERNELS``, the configuration's peaks)
    over the median device time of a call of the program's ``function``
    (``"<path>:<name>"``), from the stretch that records Python calls."""
    times = ctx.calls.get(function)
    if not times:
        return None
    return _roofline(ctx, kernel, b, statistics.median(times))


def roofline_by_name(ctx, pattern: str, kernel: str, b: int):
    """``kernel``'s bound over the mean device time of a launch of the
    kernels whose name matches ``pattern`` (one launch a call)."""
    if not ctx.summary:
        return None
    sec, launches = trace.kernel_time(ctx.summary, pattern)
    if not launches:
        return None
    return _roofline(ctx, kernel, b, sec / launches)


def _roofline(ctx, kernel: str, b: int, seconds: float):
    cfg = ctx.config
    itemsize = 4 if cfg["dtype"] == "float32" else 2
    flops, nbytes = work.KERNELS[kernel](cfg, b, itemsize)
    bound, _ = work.bound_s(flops, nbytes, cfg["peak_flops"],
                            cfg["peak_bytes_per_s"])
    return 100.0 * bound / seconds


def ms_per_unit(ctx, seconds: float, span: str):
    n = units(ctx, span)
    if n is None or ctx.summary is None:
        return None
    return 1e3 * seconds / n


def h2d_ms(ctx, span: str):
    """Device time of the host-to-device copies per unit."""
    if not ctx.summary:
        return None
    sec = sum(s for name, _, s in ctx.summary["memcpy"] if HTOD in name)
    return ms_per_unit(ctx, sec, span) if sec else None


def kernels_ms(ctx, pattern: str, span: str):
    """Device time per unit of the kernels whose name matches
    ``pattern``."""
    if not ctx.summary:
        return None
    sec, launches = trace.kernel_time(ctx.summary, pattern)
    return ms_per_unit(ctx, sec, span) if launches else None
