"""The GEMM cores of the block kernels on their own:
``C = epilogue(A [M, K] @ W [K, N])``.

Kernels 1, 2, 3 and 7 (``csrc/attention_block*.cu``, ``csrc/mlp_block*.cu``)
run their products on two cores, which :func:`gemm` reaches alone
(``csrc/gemm.cu``), so that the card tests and the timings can hold each
core to :func:`gemm_plain` and to ``torch.matmul``.  One main path calls
it: the serving forward with ``fuse_mlp=False``
(``models/fastserve.py::_mlp_unfused``: fc1 with ``"bias_gelu"``, fc2 with
``"bias_residual"``, kernel 2's own epilogues, two calls a layer).

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

The bf16 core's stored-hidden epilogues compute the GELU in a tail form on
the special-function unit (``csrc/common.cuh``, ``gelu_erf_tail`` /
``gelu_tanh_tail``; :data:`GELU_TAIL_C` and :data:`GELU_TAIL_Q` mirror its
constants), within one bf16 ulp of the exact GELU at every finite bf16
hidden value: :func:`hidden_gelu_check` runs that check on the card.
"""

from __future__ import annotations

import ctypes
import math

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
# the erf GELU's tail in the stored-hidden epilogue (csrc/common.cuh,
# gelu_erf_tail): t = 1 / (1 + GELU_TAIL_C |x|), E = t 2^(q(t) - x^2
# log2(e) / 2 - 24), q(t) = (((Q4 t + Q3) t + Q2) t + Q1) t + Q0, the
# coefficients Q4 .. Q0 in that order
GELU_TAIL_C = 0.4949747468305833
GELU_TAIL_Q = (0.361751914024353, -1.1295230388641357, 0.7219557166099548,
               1.382437825202942, 21.663318634033203)


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


def finite_bf16() -> torch.Tensor:
    """Every finite bf16 value (65,280: all 2^16 patterns but the 256 of
    inf and NaN), in the order of their bit patterns."""
    bits = torch.arange(1 << 16, dtype=torch.int32)
    bits = bits[(bits & 0x7F80) != 0x7F80]
    return (bits - ((bits >> 15) << 16)).to(torch.int16).view(torch.bfloat16)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float64) rounded to bf16 once, to nearest, ties to even: by
    way of f32 rounded to odd, which keeps the one rounding that a plain
    float64 -> f32 -> bf16 chain can get wrong at a bf16 midpoint."""
    f = x.float()
    off = (f.double() != x) & ((f.view(torch.int32) & 1) == 0)
    toward = torch.where(x > f.double(), float("inf"), float("-inf")).float()
    return torch.where(off, torch.nextafter(f, toward), f).bfloat16()


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """How many bf16 values lie from ``b`` to ``a`` (signed, int32): the
    distance of their bit patterns in value order, +0 and -0 one point."""
    def key(t):
        v = t.contiguous().view(torch.int16).int()
        return torch.where(v < 0, -(v + 32768), v)
    return key(a) - key(b)


def gelu_exact_bf16(h: torch.Tensor, approximate: bool) -> torch.Tensor:
    """The exact GELU of bf16 ``h`` in float64, rounded to bf16 once: erf,
    ``0.5 x erfc(-x / sqrt 2)``; tanh (``jax.nn.gelu(approximate=True)``'s
    formula), ``x (1 + tanh u) / 2`` written ``x sigmoid(2u)``, u =
    sqrt(2 / pi) (x + 0.044715 x^3), which does not cancel at large
    negative x."""
    x = h.double()
    if approximate:
        u = math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)
        y = x * torch.sigmoid(2.0 * u)
    else:
        y = 0.5 * x * torch.special.erfc(-x * math.sqrt(0.5))
    return bf16_round(y)


def hidden_gelu_check(approximate: bool, device=None, rows: int = 128
                      ) -> dict:
    """The bf16 core's stored-hidden epilogue at every finite bf16 hidden
    value, on the card: :func:`gemm` with ``epilogue="bias_hgelu_tanh"``
    (``approximate``) or ``"bias_hgelu_erf"`` on ``rows`` one-hot rows of
    A (K 64) and a W whose rows each hold all of :func:`finite_bf16`, zero
    bias, so that H is W's row summed with 0 (-0 becomes +0) and C the
    epilogue's GELU of each value.  Returns ``values`` (65,280),
    ``h_bit_equal`` (every row of H equal to ``W + 0`` bit for bit),
    ``rows_agree`` (every row of C equal to the first, bit for bit),
    ``max_ulps`` and ``one_ulp`` (how many values' activations lie one bf16
    ulp from :func:`gelu_exact_bf16`; ``max_ulps`` the largest distance)
    and ``worst`` (a hidden value at that distance).  Needs the card."""
    dev = torch.device(device or "cuda")
    if dev.type != "cuda":
        raise ValueError("hidden_gelu_check runs the CUDA kernel; it needs "
                         f"a CUDA device, not {dev}")
    vals = finite_bf16().to(dev)
    k = 64
    a = torch.zeros((rows, k), dtype=torch.bfloat16, device=dev)
    a[torch.arange(rows, device=dev), torch.arange(rows, device=dev) % k] = 1
    w = vals.expand(k, -1).contiguous()
    bias = torch.zeros(vals.numel(), dtype=torch.float32, device=dev)
    c, h = gemm(a, w, bias, epilogue="bias_hgelu_tanh" if approximate
                else "bias_hgelu_erf")
    want_h = (vals.float() + 0.0).bfloat16()
    want_c = gelu_exact_bf16(want_h, approximate)
    d = bf16_ulps(c[0], want_c).abs()
    worst = int(d.argmax())
    return {"values": vals.numel(),
            "h_bit_equal": bool(torch.equal(
                h.view(torch.int16), want_h.expand(rows, -1).view(
                    torch.int16))),
            "rows_agree": bool(torch.equal(
                c.view(torch.int16), c[:1].expand(rows, -1).view(
                    torch.int16))),
            "max_ulps": int(d.max()), "one_ulp": int((d == 1).sum()),
            "worst": float(want_h[worst])}
