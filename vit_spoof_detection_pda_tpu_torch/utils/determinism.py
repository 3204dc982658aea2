"""Determinism controls (counterpart of the JAX package's
``utils/determinism.py``).

The reference sets ``cudnn.deterministic=True`` AND ``cudnn.benchmark=True``
together (train_advanced.py:512-513: the autotuner wins the
nondeterminism back).  Here determinism means: one seed threaded through
every generator (the train step derives its dropout generators from
``(seed, step)``), seeded host RNGs for shuffles, and, on request,
PyTorch's deterministic algorithms.  The port's own kernels need no
switch: none of them uses atomics, and the LN backward reduces its
parameter sums in a fixed order.
"""

from __future__ import annotations

import contextlib
import os
import random

import numpy as np
import torch


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
