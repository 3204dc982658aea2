"""Row gather from the device-resident training pool (counterpart of the
JAX package's ``ops/gather_pallas.py``).

``pool_gather(pool, idx)`` returns ``pool[idx]`` along the first axis.  On
a CUDA pool it launches the hand-written kernel ``csrc/pool_gather.cu``
(it replaces the TPU kernel ``ops/gather_pallas.py::_kernel``); on a CPU
pool it runs :func:`pool_gather_plain`.  The TPU kernel wanted the pool
lane-packed ``[N, row // 128, 128]``; the port keeps it NHWC, since a row
is one contiguous run of bytes on the card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

LAUNCHES = _build.LAUNCHES
_P = ctypes.c_void_p
_SIGNATURE = ("vsd_pool_gather", [_P] * 3 + [ctypes.c_int, ctypes.c_longlong, _P])


def _host_indices(idx, n: int) -> np.ndarray:
    """``idx`` as host int32, every entry checked against ``[0, n)``."""
    if isinstance(idx, torch.Tensor):
        if idx.device.type != "cpu":
            raise ValueError("pool_gather takes host indices (numpy or a CPU "
                             "tensor), checked against the pool size before "
                             "the launch")
        idx = idx.numpy()
    idx = np.asarray(idx)
    if idx.ndim != 1 or not np.issubdtype(idx.dtype, np.integer):
        raise ValueError(f"indices must be a 1-D integer vector; got "
                         f"{idx.dtype} {idx.shape}")
    if idx.size and (idx.min() < 0 or idx.max() >= n):
        raise IndexError(f"pool indices must lie in [0, {n}); got "
                         f"[{idx.min()}, {idx.max()}]")
    return idx.astype(np.int32)


def pool_gather_plain(pool: torch.Tensor, idx) -> torch.Tensor:
    """Plain PyTorch version: ``pool.index_select(0, idx)``."""
    idx = _host_indices(idx, pool.shape[0])
    return pool.index_select(0, torch.from_numpy(idx).long().to(pool.device))


def pool_gather(pool: torch.Tensor, idx) -> torch.Tensor:
    """``[N, ...]`` pool (any dtype), ``[B]`` host indices -> ``[B, ...]``
    rows.  Indices out of range raise ``IndexError`` before any launch.
    On the card: one launch, the pool contiguous."""
    if pool.device.type == "cpu":
        return pool_gather_plain(pool, idx)
    if pool.device.type != "cuda":
        raise ValueError(f"no kernel for device {pool.device}")
    if not pool.is_contiguous():
        raise ValueError("the pool must be contiguous")
    idx = _host_indices(idx, pool.shape[0])
    if idx.size > 65535:
        raise ValueError(f"pool_gather takes at most 65535 rows; got "
                         f"{idx.size}")
    out = torch.empty((idx.size,) + tuple(pool.shape[1:]), dtype=pool.dtype,
                      device=pool.device)
    if idx.size == 0:
        return out
    dev_idx = torch.from_numpy(idx).to(pool.device, non_blocking=True)
    row_bytes = pool[0].numel() * pool.element_size()
    lib, fn = _build.entry("pool_gather", *_SIGNATURE)
    err = fn(pool.data_ptr(), dev_idx.data_ptr(), out.data_ptr(), idx.size,
             row_bytes, torch.cuda.current_stream(pool.device).cuda_stream)
    _build.check(lib, "pool_gather", err)
    LAUNCHES["pool_gather"] += 1
    return out
