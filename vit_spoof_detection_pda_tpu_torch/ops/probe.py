"""The doctor's toolchain probe as a hand-written CUDA kernel.

:func:`doctor_probe` computes ``o = 2 x`` on f32 elements: kernel
``csrc/doctor_probe.cu``, which replaces the TPU kernel of the JAX
package's ``cli/doctor.py::check_pallas`` (:115).  The ``doctor`` verb's
``pallas`` check calls it on an ``[8, 128]`` array of ones: a sum of
exactly 2048 shows that nvcc built the library for sm_90a, that ctypes
loaded it and that it launched.  A CPU tensor runs
:func:`doctor_probe_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

LAUNCHES = _build.LAUNCHES


def doctor_probe_plain(x: torch.Tensor) -> torch.Tensor:
    return 2 * x


def doctor_probe(x: torch.Tensor) -> torch.Tensor:
    """``2 x`` of an f32 tensor: the plain version on the CPU, the kernel
    (``LAUNCHES["doctor_probe"]``) on the card."""
    if x.device.type == "cpu":
        return doctor_probe_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous() or not x.numel():
        raise ValueError("the probe takes a non-empty contiguous f32 tensor; "
                         f"got {x.dtype}, shape {tuple(x.shape)}")
    lib, fn = _build.entry("doctor_probe", "vsd_doctor_probe",
                           [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                            ctypes.c_void_p])
    out = torch.empty_like(x)
    err = fn(x.data_ptr(), out.data_ptr(), x.numel(),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, "doctor_probe", err)
    LAUNCHES["doctor_probe"] += 1
    return out
