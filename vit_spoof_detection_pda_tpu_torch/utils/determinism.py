"""Determinism controls (counterpart of the JAX package's
``utils/determinism.py``).

The reference sets ``cudnn.deterministic=True`` AND ``cudnn.benchmark=True``
together (train_advanced.py:512-513: the autotuner wins the
nondeterminism back).  Here determinism means: one seed threaded through
every generator (the train step derives its dropout generators from
``(seed, step)``), seeded host RNGs for shuffles, and, on request,
PyTorch's deterministic algorithms.  The port's own kernels need no
switch: none of them uses atomics, and the LN backward reduces its
parameter sums in a fixed order.  :func:`enable_debug_nans` is the
numerical sanitizer.
"""

from __future__ import annotations

import contextlib
import os
import random

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


def seed_everything(seed: int) -> torch.Generator:
    """Seed Python's, NumPy's and PyTorch's global generators (the card's
    too) and return a CPU ``torch.Generator`` seeded with ``seed`` (the
    JAX package returns its root PRNG key).  Replaces the reference's
    seeding block (train_advanced.py:507-513)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)        # seeds every CUDA device as well
    # only affects CHILD processes: CPython reads PYTHONHASHSEED at start
    os.environ.setdefault("PYTHONHASHSEED", str(seed))
    return torch.Generator().manual_seed(seed)


# ops whose output is uninitialized memory or a view of another tensor:
# their values are not produced by the op, so they are not checked
_UNCHECKED = frozenset(("empty", "empty_like", "empty_strided", "new_empty",
                        "new_empty_strided", "resize_"))


class _NanCheck(TorchDispatchMode):
    """Raise ``FloatingPointError`` on the first floating-point output of
    an operator that holds a NaN, in the forward and, since a dispatch
    mode reaches the autograd engine's operators too, in the backward.
    A hand-written kernel's output is checked by the first operator that
    reads it."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        packet = func.overloadpacket.__name__
        if packet in _UNCHECKED or func.is_view:
            return out
        for t in tree_flatten(out)[0]:
            if (type(t) is torch.Tensor and t.is_floating_point()
                    and t.device.type != "meta" and bool(t.isnan().any())):
                raise FloatingPointError(
                    f"invalid value (nan) encountered in {func}")
        return out


_nan_state: dict = {}


def enable_debug_nans(enabled: bool = True):
    """Raise ``FloatingPointError`` at the first NaN that any operator
    produces, in the forward or the backward (JAX's ``jax_debug_nans``):
    a NaN-checking dispatch mode on this thread, plus
    ``torch.autograd.set_detect_anomaly(True, check_nan=True)``, which
    names the forward operator behind a failing backward one.  Each op's
    check synchronizes with the card, so this is a debugging switch.
    ``enabled=False`` leaves the mode and restores the anomaly setting
    that was in force before."""
    if enabled and "mode" not in _nan_state:
        _nan_state["anomaly"] = (torch.is_anomaly_enabled(),
                                 torch.is_anomaly_check_nan_enabled())
        torch.autograd.set_detect_anomaly(True, check_nan=True)
        mode = _NanCheck()
        mode.__enter__()
        _nan_state["mode"] = mode
    elif not enabled and "mode" in _nan_state:
        _nan_state.pop("mode").__exit__(None, None, None)
        torch.autograd.set_detect_anomaly(*_nan_state.pop("anomaly"))


@contextlib.contextmanager
def strict_determinism():
    """Context: PyTorch's deterministic algorithms
    (``torch.use_deterministic_algorithms``: an op without a deterministic
    form raises instead of running), cuDNN's deterministic kernels and no
    autotuner, and f32 matmuls at full precision (the JAX package pins
    ``jax_default_matmul_precision="highest"``).  cuBLAS needs
    ``CUBLAS_WORKSPACE_CONFIG`` before its first handle, so it is set
    here only if unset.  Everything is restored on exit."""
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark,
            torch.get_float32_matmul_precision())
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        torch.backends.cudnn.deterministic = prev[2]
        torch.backends.cudnn.benchmark = prev[3]
        torch.set_float32_matmul_precision(prev[4])
