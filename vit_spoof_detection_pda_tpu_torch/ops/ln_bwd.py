"""LayerNorm + residual backward as one hand-written CUDA kernel
(counterpart of the JAX package's ``ops/ln_bwd.py``).

Every sub-layer of the ViT is ``y = x + f(LN(x))``; given the cotangent
``g`` of ``y`` and ``dxn`` of the LN's affine output, the tail is

    dxh = dxn * scale
    dx  = g + inv * (dxh - mean(dxh) - xh * mean(dxh * xh))
    dscale = sum(dxn * xh);  dbias = sum(dxn)

with ``xh`` the stored normalized input and ``inv = rsqrt(var + eps)``
per row.  Kernel: ``csrc/ln_res_bwd.cu``; replaces ``_ln_res_bwd_kernel``
(JAX ``ops/ln_bwd.py:45``).  The TPU kernel summed ``dscale`` and
``dbias`` across its sequential grid; the CUDA kernel runs one launch on
a grid sized to the card, each block writing a partial row that the last
blocks to finish add in a fixed order (ticket counters in device memory,
zeroed once per device and stream and left zero by every call), so the
sums are the same from run to run.  The grid and the scratch come from
one rule in C (``vsd_ln_res_bwd_plan``, :func:`ln_bwd_plan`).  The f32
form (f32 ``xh``, ``g`` and ``dxn``, for ``compute_dtype="float32"``)
is the same kernel templated on the type.

Padding contract: rows with ``dxn = g = 0`` come out with ``dx`` exactly
0 and add nothing to the sums, so row-padded operands need no masking.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .attention import _require

LAUNCHES = _build.LAUNCHES
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURE = ("vsd_ln_res_bwd", [_P] * 10 + [_L] * 2 + [_I] * 4 + [_P])
_PLAN_SIGNATURE = ("vsd_ln_res_bwd_plan", [_I] * 4 + [_P])
_PLAN_KEYS = ("blocks", "finishers", "scratch", "tickets", "per_sm", "sms",
              "smem")
_plans: dict = {}      # (device, rows, d, dxn_f32, x_f32) -> plan
_tickets: dict = {}    # (device, stream) -> the zeroed ticket counters


def ln_residual_bwd_plain(xh, inv, dxn, g, lns):
    """Plain PyTorch version of the kernel (the counterpart of
    ``ln_residual_bwd_reference``): f32 math, ``dx`` rounded to
    ``xh.dtype``, the sums f32."""
    d = xh.shape[-1]
    dxn = dxn.float()
    xh32 = xh.float()
    dxh = dxn * lns.float()
    m1 = dxh.mean(-1, keepdim=True)
    m2 = (dxh * xh32).mean(-1, keepdim=True)
    dx = (g.float() + inv.float() * (dxh - m1 - xh32 * m2)).to(xh.dtype)
    dlns = (dxn * xh32).reshape(-1, d).sum(0)
    dlnb = dxn.reshape(-1, d).sum(0)
    return dx, dlns, dlnb


def ln_bwd_plan(rows: int, d: int, dxn_f32: bool, x_f32: bool,
                device) -> dict:
    """The launch plan of one call on ``device`` (a CUDA device), from the
    C launcher's own rule (``vsd_ln_res_bwd_plan``), read once per shape:
    ``blocks`` = min(ceil(rows / 16), ``per_sm`` x ``sms``), the blocks
    of the kernel's instance that fit an SM times the SMs; the last
    ``finishers`` blocks to finish add the partial rows; ``scratch``
    floats and ``tickets`` counters; ``smem`` bytes a block."""
    dev = torch.device(device)
    key = (dev.index, rows, d, bool(dxn_f32), bool(x_f32))
    plan = _plans.get(key)
    if plan is None:
        lib, fn = _build.entry("ln_res_bwd", *_PLAN_SIGNATURE)
        out = (ctypes.c_longlong * len(_PLAN_KEYS))()
        with torch.cuda.device(dev):
            _build.check(lib, "ln_res_bwd_plan",
                         fn(rows, d, int(dxn_f32), int(x_f32), out))
        plan = _plans[key] = dict(zip(_PLAN_KEYS, out))
    return plan


def _ticket_counters(dev, stream, n: int) -> torch.Tensor:
    """At least ``n`` int32 ticket counters for calls on ``stream``: zeroed
    when first made (one memset per device and stream), then left zero by
    every launch (the last finisher past its wait resets them).  Calls on
    one stream run in order, so they share one set."""
    key = (dev.index, stream)
    t = _tickets.get(key)
    if t is None or t.numel() < n:
        t = _tickets[key] = torch.zeros(max(n, 64), dtype=torch.int32,
                                        device=dev)
    return t


def ln_residual_bwd(xh, inv, dxn, g, lns):
    """``dx, dscale, dbias`` for ``y = x + f(LN(x))``.

    xh   [B, Tq, D] stored normalized input
    inv  [B, Tq, 1] f32 rsqrt(var + eps) per row
    dxn  [B, Tq, D] cotangent of the LN affine output
    g    [B, Tq, D] cotangent of y (flows through the residual)
    lns  [D] f32 LN scale

    Returns ``dx [B, Tq, D]`` in ``xh.dtype``, ``dscale [D]`` and
    ``dbias [D]`` f32.  On the card: bf16 ``xh`` and ``g`` with bf16 or
    f32 ``dxn``, or f32 ``xh``, ``g`` and ``dxn`` (the f32 form,
    ``LAUNCHES["ln_res_bwd_f32"]``); contiguous, D a multiple of 8 up to
    1024."""
    if xh.device.type == "cpu":
        return ln_residual_bwd_plain(xh, inv, dxn, g, lns)
    if xh.device.type != "cuda":
        raise ValueError(f"no kernel for device {xh.device}")
    b, tq, d = xh.shape
    if d % 8 or d > 1024:
        raise ValueError(f"the LN backward kernel takes D a multiple of 8 "
                         f"up to 1024; got {d}")
    bf, f32, dev = torch.bfloat16, torch.float32, xh.device
    xdt = xh.dtype
    if xdt not in (bf, f32) or dxn.dtype not in (bf, f32) or (
            xdt == f32 and dxn.dtype != f32):
        raise TypeError(f"xh {xdt}, dxn {dxn.dtype}: the kernel takes bf16 "
                        "xh with bf16 or f32 dxn, or f32 xh and dxn")
    _require(xh, "xh", xdt, (b, tq, d), dev)
    _require(inv, "inv", f32, (b, tq, 1), dev)
    _require(dxn, "dxn", dxn.dtype, (b, tq, d), dev)
    _require(g, "g", xdt, (b, tq, d), dev)
    _require(lns, "lns", f32, (d,), dev)
    rows = b * tq
    dxn_f32, x_f32 = dxn.dtype == f32, xdt == f32
    plan = ln_bwd_plan(rows, d, dxn_f32, x_f32, dev)
    lib, fn = _build.entry("ln_res_bwd", *_SIGNATURE)
    stream = torch.cuda.current_stream(dev.index).cuda_stream
    tickets = _ticket_counters(dev, stream, plan["tickets"])
    dx = torch.empty_like(xh)
    scratch = torch.empty(plan["scratch"], dtype=f32, device=dev)
    sums = torch.empty((2, d), dtype=f32, device=dev)
    err = fn(xh.data_ptr(), inv.data_ptr(), dxn.data_ptr(), g.data_ptr(),
             lns.data_ptr(), dx.data_ptr(), scratch.data_ptr(),
             sums[0].data_ptr(), sums[1].data_ptr(), tickets.data_ptr(),
             plan["scratch"], tickets.numel(), rows, d, int(dxn_f32),
             int(x_f32), stream)
    name = "ln_res_bwd_f32" if xdt == f32 else "ln_res_bwd"
    _build.check(lib, name, err)
    LAUNCHES[name] += 1
    return dx, sums[0], sums[1]
