"""The GEMM cores of the block kernels on their own:
``C = epilogue(A [M, K] @ W [K, N])``.

Kernels 1, 2, 3 and 7 (``csrc/attention_block*.cu``, ``csrc/mlp_block*.cu``)
run their products on two cores, which :func:`gemm` reaches alone
(``csrc/gemm.cu``), so that the card tests and the timings can hold each
core to :func:`gemm_plain` and to ``torch.matmul``; nothing on a main path
calls it.

- bf16: the TMA-fed, warp-specialised, persistent wgmma core
  (``csrc/gemm_core.cuh``; ``LAUNCHES["gemm"]``).  :func:`gemm_plan`
  mirrors its launcher's choice (tile, stages, grid, shared memory), which
  :func:`gemm_launch_config` reads from the library (``vsd_gemm_plan``).
- f32: the FMA GEMM of ``csrc/f32_common.cuh``, never TF32
  (``LAUNCHES["gemm_f32"]``).

:func:`core_launches` reads each core's launches, which the C launchers
count where they launch it (two a call of kernels 1, 2, 3 and 7, one a
call of :func:`gemm`), so that a run can show that its main path went
through the cores.

Epilogues (the blocks' own, with their rounding points): ``"bias"``
``acc + b``; ``"bias_gelu"`` ``gelu_tanh(acc + b)`` (bf16 only);
``"bias_residual"`` ``(r + acc) + b``; ``"bias_hgelu_erf"`` /
``"bias_hgelu_tanh"`` ``H = round(acc + b)``, ``C = round(gelu(H))``, which
return ``(C, H)``.  Products are exact f32 products of the inputs summed in
f32; the output is rounded to the input dtype once.
"""

from __future__ import annotations

import ctypes

import torch

from ..device import exact_f32_matmul
from . import _build
from .gelu import gelu

LAUNCHES = _build.LAUNCHES
core_launches = _build.core_launches

EPILOGUES = ("bias", "bias_gelu", "bias_residual", "bias_hgelu_erf",
             "bias_hgelu_tanh")
H100_SMS = 132
MAX_SMEM = 232448
# the bf16 core (csrc/gemm_core.cuh): 128 x 256 tiles, 64-deep stages
BM, BN, BK, STAGES, THREADS, GROUP_M = 128, 256, 64, 4, 384, 8
# the ring, two 64 x 128 staging tiles of the epilogue, 10 mbarriers, alignment
_SMEM = (STAGES * (BM * BK + BK * BN) * 2 + 2 * 64 * 128 * 2
         + (2 * STAGES + 2) * 8 + 1024)
PLAN_KEYS = ("bm", "bn", "bk", "stages", "tiles_m", "tiles_n", "tiles",
             "grid", "smem", "group_m", "threads")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def check_shape(m: int, n: int, k: int, dtype) -> None:
    """Raise ``ValueError`` naming the limit on a shape the cores do not
    take: N and K multiples of 8 in bf16 (TMA's 16-byte strides) or 4 in
    f32 (16-byte loads), all positive, M >= 0."""
    align = 4 if dtype == torch.float32 else 8
    if m < 0 or n <= 0 or k <= 0:
        raise ValueError(f"GEMM shape M {m}, N {n}, K {k}: M must be >= 0, "
                         "N and K > 0")
    if n % align or k % align:
        raise ValueError(f"the {'f32' if align == 4 else 'bf16'} GEMM core "
                         f"takes N and K that are multiples of {align} "
                         f"(16-byte rows); got N {n}, K {k}")


def gemm_plan(m: int, n: int, k: int, sms: int = H100_SMS) -> dict:
    """The bf16 core's launch for an M x N x K product on ``sms`` SMs, as
    ``csrc/gemm_core.cuh::gemm_plan`` chooses it: tiles of ``bm`` x ``bn``
    (``tiles_m`` x ``tiles_n`` of them), ``stages`` 64-deep stages,
    ``grid`` = min(tiles, SMs) persistent blocks of ``threads`` (one an
    SM, ``smem`` bytes of dynamic shared memory), each walking the tiles
    ``b, b + grid, ...`` in groups of ``group_m`` m-tiles
    (:func:`gemm_tile`).  Raises ``ValueError`` naming the limit on N or K
    that the core does not take."""
    check_shape(m, n, k, torch.bfloat16)
    if m <= 0:
        raise ValueError(f"GEMM shape M {m}: the plan needs M > 0")
    tiles_m, tiles_n = _cdiv(m, BM), _cdiv(n, BN)
    tiles = tiles_m * tiles_n
    return {"bm": BM, "bn": BN, "bk": BK, "stages": STAGES,
            "tiles_m": tiles_m, "tiles_n": tiles_n, "tiles": tiles,
            "grid": min(tiles, sms), "smem": _SMEM, "group_m": GROUP_M,
            "threads": THREADS}


def gemm_tile(plan: dict, t: int) -> tuple:
    """``(m0, n0)`` of tile ``t`` in the grouped raster of ``plan``
    (``csrc/gemm_core.cuh::gemm_tile``): groups of ``group_m`` m-tiles,
    each sweeping every n-tile, m fastest inside a group."""
    per_group = plan["group_m"] * plan["tiles_n"]
    g, r = divmod(t, per_group)
    first = g * plan["group_m"]
    gm = min(plan["tiles_m"] - first, plan["group_m"])
    return (first + r % gm) * plan["bm"], (r // gm) * plan["bn"]


def block_tiles(plan: dict, block: int) -> list:
    """The tiles block ``block`` of the persistent grid walks, in order."""
    return list(range(block, plan["tiles"], plan["grid"]))


def gemm_launch_config(m: int, n: int, k: int, sms: int = 0) -> dict:
    """The bf16 core's plan as its C launcher reports it
    (``vsd_gemm_plan``, on this card's SM count when ``sms`` is 0), with
    :func:`gemm_plan`'s keys.  Needs the card."""
    lib, fn = _build.entry("gemm", "vsd_gemm_plan", [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_int])
    out = (ctypes.c_int * len(PLAN_KEYS))()
    n_out = fn(m, n, k, sms, out, len(PLAN_KEYS))
    if n_out != len(PLAN_KEYS):
        raise RuntimeError(f"vsd_gemm_plan returned {n_out} values")
    return dict(zip(PLAN_KEYS, out))


def gemm_plain(a, w, bias, *, epilogue: str = "bias", residual=None):
    """Plain PyTorch version of the cores: exact f32 products of ``a`` and
    ``w`` summed in f32, the epilogue in f32, each output rounded to
    ``a.dtype`` once (``H`` before the GELU reads it)."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue {epilogue!r} is not one of {EPILOGUES}")
    cdt = a.dtype
    with exact_f32_matmul():
        acc = torch.matmul(a.float(), w.float())
        if epilogue == "bias":
            return (acc + bias.float()).to(cdt)
        if epilogue == "bias_gelu":
            return gelu(acc + bias.float(), approximate=True).to(cdt)
        if epilogue == "bias_residual":
            return ((residual.float() + acc) + bias.float()).to(cdt)
        h = (acc + bias.float()).to(cdt)
        c = torch.nn.functional.gelu(
            h.float(), approximate="tanh" if epilogue == "bias_hgelu_tanh"
            else "none").to(cdt)
        return c, h


def gemm(a, w, bias, *, epilogue: str = "bias", residual=None):
    """``epilogue(a [M, K] @ w [K, N])`` -> ``[M, N]`` in ``a.dtype`` (a
    pair ``(C, H)`` for the stored-hidden epilogues).  A CPU tensor runs
    :func:`gemm_plain`; a CUDA one the bf16 core (bf16 ``a``, ``w`` and
    ``residual``) or the f32 GEMM (all f32; no ``"bias_gelu"``), with an
    f32 ``bias [N]``; raises on anything else."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue {epilogue!r} is not one of {EPILOGUES}")
    if (epilogue == "bias_residual") != (residual is not None):
        raise ValueError("a residual goes with the 'bias_residual' epilogue "
                         "and with no other")
    if a.device.type == "cpu":
        return gemm_plain(a, w, bias, epilogue=epilogue, residual=residual)
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")
    cdt = a.dtype
    if cdt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"a is {cdt}; the GEMM cores take bfloat16 or "
                        "float32")
    f32 = cdt == torch.float32
    if f32 and epilogue == "bias_gelu":
        raise ValueError("the f32 GEMM has no 'bias_gelu' epilogue")
    m, k = a.shape
    n = w.shape[-1]
    check_shape(m, n, k, cdt)
    for t, what, dt, shape in ((a, "a", cdt, (m, k)), (w, "w", cdt, (k, n)),
                               (bias, "bias", torch.float32, (n,))) + (
            ((residual, "residual", cdt, (m, n)),) if residual is not None
            else ()):
        if t.dtype != dt or tuple(t.shape) != shape or t.device != a.device:
            raise ValueError(f"{what} must be {dt} {shape} on {a.device}; "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what} must be contiguous and 16-byte "
                             "aligned")
    hidden = epilogue.startswith("bias_hgelu")
    c = torch.empty((m, n), dtype=cdt, device=a.device)
    h = torch.empty((m, n), dtype=cdt, device=a.device) if hidden else None
    lib, fn = _build.entry("gemm", "vsd_gemm", [ctypes.c_void_p] * 6 + [
        ctypes.c_int] * 5 + [ctypes.c_void_p])
    err = fn(a.data_ptr(), w.data_ptr(), bias.data_ptr(),
             residual.data_ptr() if residual is not None else None,
             c.data_ptr(), h.data_ptr() if hidden else None, m, n, k,
             EPILOGUES.index(epilogue), int(f32),
             torch.cuda.current_stream(a.device).cuda_stream)
    name = "gemm_f32" if f32 else "gemm"
    _build.check(lib, name, err)
    LAUNCHES[name] += 1
    return (c, h) if hidden else c
