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
``dbias`` across its sequential grid; the CUDA kernel writes per-block
partial sums and reduces them in a second launch in a fixed order, so
the sums are the same from run to run.  The f32 form (f32 ``xh``, ``g``
and ``dxn``, for ``compute_dtype="float32"``) is the same kernel
templated on the type.

Padding contract: rows with ``dxn = g = 0`` come out with ``dx`` exactly
0 and add nothing to the sums, so row-padded operands need no masking.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .attention import _require

LAUNCHES = _build.LAUNCHES
_LN_ROWS_PER_BLOCK = 128     # rows of one partial sum (csrc/ln_res_bwd.cu)
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURE = ("vsd_ln_res_bwd", [_P] * 9 + [_I] * 4 + [_P])


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
    blocks = max(1, -(-rows // _LN_ROWS_PER_BLOCK))
    lib, fn = _build.entry("ln_res_bwd", *_SIGNATURE)
    dx = torch.empty_like(xh)
    partial = torch.empty((2, blocks, d), dtype=f32, device=dev)
    sums = torch.empty((2, d), dtype=f32, device=dev)
    err = fn(xh.data_ptr(), inv.data_ptr(), dxn.data_ptr(), g.data_ptr(),
             lns.data_ptr(), dx.data_ptr(), partial.data_ptr(),
             sums[0].data_ptr(), sums[1].data_ptr(), rows, d,
             int(dxn.dtype == f32), int(xdt == f32),
             torch.cuda.current_stream(dev).cuda_stream)
    name = "ln_res_bwd_f32" if xdt == f32 else "ln_res_bwd"
    _build.check(lib, name, err)
    LAUNCHES[name] += 1
    return dx, sums[0], sums[1]
