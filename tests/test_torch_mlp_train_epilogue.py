"""Kernel 7's stored-hidden fc1 epilogue on the CPU (``csrc/gemm_core.cuh``,
``gemm_epilogue_hidden``; ``csrc/common.cuh``, ``gelu_erf_tail`` and
``gelu_tanh_tail``).

- The two GELU forms, emulated line by line in numpy f32 (with exact
  ``exp2`` and division where the card runs ``ex2.approx`` and
  ``rcp.approx``, and ``ex2.approx.ftz``'s flush of results below 2^-126),
  over every finite bf16 hidden value: within one bf16 ulp of the exact
  GELU of their flavour, in each range of x, below -3 (where ``1 + erf``
  and ``1 + tanh`` cancel in f32) and in the subnormals included.
- The exact GELU the checks use (``ops/gemm.py::gelu_exact_bf16``) against
  an independent float64 ``math.erfc`` and rounding, and the f32
  ``1 + erf`` form against it (it cancels, so it is many ulps off).
- The constants: ``ops/gemm.py`` mirrors those of ``common.cuh``, and the
  erf tail's fit holds its stated relative error.
- The staging layout of the one-pass epilogue: every thread's H and C
  slots cover each 64 x 64 box of the staging tile once, in the 128-byte
  swizzle the TMA store reads, and each warp's store hits 32 banks.

On the card, ``tests/test_torch_kernels_cuda.py`` runs the same
exhaustive check on the kernel (``ops/gemm.py::hidden_gelu_check``).
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from vit_spoof_detection_pda_tpu_torch.ops import gemm as tgemm

CSRC = Path(tgemm.__file__).resolve().parent.parent / "csrc"
F = np.float32
LOG2E = math.log2(math.e)


def _c_float(src: str, name: str) -> float:
    m = re.search(rf"constexpr float {name} = ([-0-9.e]+)f;", src)
    assert m, name
    return float(m.group(1))


def _common() -> str:
    return (CSRC / "common.cuh").read_text()


def _fn_body(src: str, name: str) -> str:
    start = src.index(f"float {name}(float x)")
    return src[start:src.index("\n}\n", start)]


def _floats(body: str) -> list:
    return [float(v) for v in re.findall(r"(-?[0-9]+\.[0-9]+(?:e-?[0-9]+)?)f",
                                         body)]


def _fma(a, b, c):
    """f32 fma: the float64 product of two f32 values is exact; one
    rounding to f32 after the add."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(F)


def _ex2_ftz(a):
    r = np.exp2(np.asarray(a, np.float64)).astype(F)
    return np.where(r < F(2.0 ** -126), F(0), r)


def _rcp(a):
    return (1.0 / np.asarray(a, np.float64)).astype(F)


def gelu_erf_tail_f32(x):
    """``common.cuh::gelu_erf_tail`` line by line in f32."""
    q4, q3, q2, q1, q0 = (F(v) for v in tgemm.GELU_TAIL_Q)
    t = _rcp(_fma(np.abs(x), F(tgemm.GELU_TAIL_C), F(1)))
    q = _fma(q4, t, q3)
    q = _fma(q, t, q2)
    q = _fma(q, t, q1)
    q = _fma(q, t, q0)
    e = _ex2_ftz(_fma(x * x, F(-0.5 * LOG2E), q))
    return (np.maximum(x, F(0)) - (np.abs(x) * t) * (e * F(2.0 ** -24))
            ).astype(F)


def gelu_tanh_tail_f32(x):
    """``common.cuh::gelu_tanh_tail`` line by line in f32."""
    s = x * _fma(F(-0.1029432395800235), x * x, F(-2.302208198144325))
    sm = _ex2_ftz(F(24) - np.abs(s)) * F(2.0 ** -24)
    xr = x * _rcp(F(1) + sm)
    return np.where(x < 0, xr * sm, xr).astype(F)


def _bf16_bits(v32):
    """f32 -> bf16 bit patterns, to nearest, ties to even (as
    ``__floats2bfloat162_rn``)."""
    u = np.asarray(v32, F).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def _to_bf16(v32) -> torch.Tensor:
    return torch.from_numpy(_bf16_bits(v32).view(np.int16)).view(
        torch.bfloat16)


@pytest.fixture(scope="module")
def hidden():
    h = tgemm.finite_bf16()
    return h, h.float().numpy()


@pytest.fixture(scope="module")
def exact(hidden):
    h, _ = hidden
    return {False: tgemm.gelu_exact_bf16(h, False),
            True: tgemm.gelu_exact_bf16(h, True)}


RANGES = {"below_minus_3": lambda x: x < -3,
          "minus_3_to_0": lambda x: (x >= -3) & (x < 0),
          "positive": lambda x: x >= F(2.0 ** -126),
          "subnormal_and_zero": lambda x: np.abs(x) < F(2.0 ** -126)}


@pytest.mark.parametrize("approximate", [False, True])
@pytest.mark.parametrize("part", list(RANGES))
def test_tail_gelu_within_one_bf16_ulp_of_exact(hidden, exact, approximate,
                                                part):
    h, x = hidden
    keep = RANGES[part](x)
    assert keep.sum() > 200
    fn = gelu_tanh_tail_f32 if approximate else gelu_erf_tail_f32
    with np.errstate(over="ignore", invalid="ignore"):
        got = _to_bf16(fn(x))
    d = tgemm.bf16_ulps(got, exact[approximate])[torch.from_numpy(keep)]
    assert int(d.abs().max()) <= 1, float(
        h[torch.from_numpy(keep)][int(d.abs().argmax())])


def test_exact_reference_matches_math_erfc(hidden, exact):
    """gelu_exact_bf16 (torch float64, f32 rounded to odd) equals
    ``0.5 x erfc(-x / sqrt 2)`` by ``math.erfc``, rounded to bf16 by exact
    rational arithmetic on the float64 value."""
    h, x = hidden
    want = []
    for v in x.astype(np.float64).tolist():
        y = 0.5 * v * math.erfc(-v * math.sqrt(0.5))
        if y == 0:
            want.append(0x8000 if math.copysign(1, y) < 0 else 0)
            continue
        m, e = math.frexp(abs(y))
        q = max(e - 8, -133)               # the bf16 quantum at |y|
        n = round(abs(y) / 2.0 ** q)       # ties to even
        bits = int(_bf16_bits(F(n * 2.0 ** q)))
        want.append(bits | (0x8000 if y < 0 else 0))
    got = exact[False].view(torch.int16).numpy().view(np.uint16)
    assert np.array_equal(got, np.array(want, np.uint16))


def test_one_plus_erf_cancels_below_minus_3(hidden, exact):
    """``0.5 x (1 + erf(x / sqrt 2))`` in f32 (the f32 kernels' form with
    erff; here torch's f32 erf) is many bf16 ulps off below -3 and within
    one above it: what the tail form removes."""
    h, x = hidden
    xt = h.float()
    got = (0.5 * xt * (1.0 + torch.erf(xt * math.sqrt(0.5)))).bfloat16()
    d = tgemm.bf16_ulps(got, exact[False]).abs()
    low = torch.from_numpy(x < -3)
    assert int(d[low].max()) > 100
    assert int(d[~low & torch.isfinite(xt) & (xt.abs() < 1e30)].max()) <= 1


def test_python_mirrors_the_c_constants():
    src = _common()
    assert _c_float(src, "kGeluTailC") == pytest.approx(
        tgemm.GELU_TAIL_C, rel=0, abs=0)
    q = [_c_float(src, f"kGeluTailQ{i}") for i in (4, 3, 2, 1, 0)]
    assert tuple(q) == tgemm.GELU_TAIL_Q
    assert F(tgemm.GELU_TAIL_C) == F(0.7 / math.sqrt(2.0))
    erf_body = _fn_body(src, "gelu_erf_tail")
    assert F(-0.5 * LOG2E) in [F(v) for v in _floats(erf_body)]
    assert F(2.0 ** -24) in [F(v) for v in _floats(erf_body)]
    # the tanh tail's exponent is gelu_tanh_fast's, constant for constant
    tanh_body = _fn_body(src, "gelu_tanh_tail")
    fast = _floats(_fn_body(src, "gelu_tanh_fast"))
    assert fast[:2] == _floats(tanh_body)[:2] == [-0.1029432395800235,
                                                  -2.302208198144325]
    c0 = -2.0 * math.sqrt(2.0 / math.pi) * LOG2E
    assert F(fast[1]) == F(c0) and F(fast[0]) == F(0.044715 * c0)


def test_erf_tail_fit_holds_its_stated_error():
    """q(t) = log2(e) g(t) + 23 with g(t) = ln(erfcx(u) / t): 6.0e-5
    relative in E over u in [0, 10] (|x| <= 14.1); past it x E lies below
    half the smallest bf16 subnormal for x < 0, and E below half an ulp of
    1 for x > 0, so the fit's end does not reach a rounded result."""
    p = 0.7
    u = np.linspace(0.0, 10.0, 4001)
    t = 1.0 / (1.0 + p * u)
    g = np.log(np.array([math.erfc(v) * math.exp(v * v) for v in u]) / t)
    q = np.polyval(np.array(tgemm.GELU_TAIL_Q, np.float64), t)
    rel = np.abs((q - 23.0) / LOG2E - g)
    assert rel.max() < 6.1e-5
    x = 10.0 * math.sqrt(2.0)
    tail = 0.5 * math.erfc(10.0)
    assert x * tail < 2.0 ** -134 and tail < 2.0 ** -9


def test_hidden_gelu_check_needs_the_card():
    with pytest.raises(ValueError, match="CUDA"):
        tgemm.hidden_gelu_check(False, device="cpu")


def _hidden_slots():
    """(thread, group jj, row half h) -> byte offset of the thread's bf16
    pair in a 64 x 64 box, as ``gemm_epilogue_hidden`` writes it (H at
    that offset in the first box, C in the second), and the (row, column)
    of the accumulator pair it holds."""
    out = {}
    for wt in range(128):
        lane = wt & 31
        r_lo, cq = (wt >> 5) * 16 + (lane >> 2), (lane & 3) * 2
        for jj in range(8):
            for h in range(2):
                r = r_lo + 8 * h
                out[wt, jj, h] = (r * 128 + ((jj ^ (r & 7)) << 4) + cq * 2,
                                  r, 8 * jj + cq)
    return out


def test_hidden_staging_covers_each_box_once_in_the_tma_swizzle():
    slots = _hidden_slots()
    box = tgemm.BK * 64 * 2                      # a 64 x 64 bf16 TMA box
    seen = np.zeros(box // 4, np.int32)
    for at, r, c in slots.values():
        seen[at // 4] += 1
        # the 128-byte swizzle: 16-byte chunk c // 8 of row r sits at
        # chunk (c // 8) ^ (r % 8)
        assert at == r * 128 + (((c // 8) ^ (r % 8)) * 16) + (c % 8) * 2
    assert (seen == 1).all()
    # one warp's store of one (jj, h): 32 distinct banks
    for warp in range(4):
        for jj in range(8):
            for h in range(2):
                banks = {(slots[32 * warp + lane, jj, h][0] // 4) % 32
                         for lane in range(32)}
                assert len(banks) == 32
    # H and C of the same box side by side: the warpgroup's staging tile
    # (two boxes) is what the serving epilogue stages 128 columns in
    assert 2 * box == 64 * 128 * 2



def _rcp_ftz(a):
    r = _rcp(a)
    return np.where(np.abs(r) < F(2.0 ** -126), F(0), r)


def test_serving_gelu_tanh_fast_flushes_where_the_tail_form_does_not(
        hidden, exact):
    """Kernel 2's fc1 GELU (``common.cuh::gelu_tanh_fast``, x / (1 + 2^s),
    left as it is): within one bf16 ulp at every finite bf16 value but four,
    x in [-10.25, -10.0625], where 2^s overflows (or its reciprocal is
    flushed) and the result is -0 while the exact GELU is a bf16 of about
    1e-38; the tail form (above) holds there too."""
    h, x = hidden
    with np.errstate(over="ignore", invalid="ignore"):
        s = x * _fma(F(-0.1029432395800235), x * x, F(-2.302208198144325))
        got = _to_bf16(x * _rcp_ftz(F(1) + _ex2_ftz(s)))
    d = tgemm.bf16_ulps(got, exact[True]).abs()
    off = (d > 1).numpy()
    assert off.sum() == 4
    assert x[off].min() == -10.25 and x[off].max() == -10.0625
    assert (got.float().numpy()[off] == 0).all()
