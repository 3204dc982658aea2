"""The GEMM cores of the block kernels (``ops/gemm.py``): the bf16 core's
plan (``gemm_plan``, which mirrors ``csrc/gemm_core.cuh``'s launcher) and
the plain version the card tests hold both cores to.  Nothing here needs
the card: the plan is chosen by shape before any launch, and on the CPU
the wrapper runs the plain version."""

import math

import numpy as np
import pytest
import torch

from vit_spoof_detection_pda_tpu_torch.ops import attention as tatt
from vit_spoof_detection_pda_tpu_torch.ops import gemm as tgemm

MAX_SMEM = 232448
H100_SMS = 132
# ViT-B/16's four products (N, K) at B = 1, 2, 32 and 128 (M = B x Tp 200),
# and ragged M, N and K
VIT_B = ((2304, 768), (768, 768), (3072, 768), (768, 3072))
PLAN_SHAPES = [(b * 200, n, k) for b in (1, 2, 32, 128) for n, k in VIT_B] + [
    (m, n, k) for m in (1, 130, 25216) for n in (8, 776) for k in (8, 72)]


@pytest.mark.parametrize("m,n,k", PLAN_SHAPES)
def test_gemm_plan_tiles_cover_every_output_once(m, n, k):
    """The persistent blocks' tiles, walked as the kernel walks them,
    cover every tile of the output exactly once, and the tiles cover
    [0, M) x [0, N)."""
    plan = tgemm.gemm_plan(m, n, k)
    seen = [tgemm.gemm_tile(plan, t) for b in range(plan["grid"])
            for t in tgemm.block_tiles(plan, b)]
    assert len(seen) == len(set(seen)) == plan["tiles"]
    assert set(seen) == {(i * plan["bm"], j * plan["bn"])
                         for i in range(plan["tiles_m"])
                         for j in range(plan["tiles_n"])}
    assert plan["tiles_m"] * plan["bm"] >= m > (plan["tiles_m"] - 1) * plan[
        "bm"]
    assert plan["tiles_n"] * plan["bn"] >= n > (plan["tiles_n"] - 1) * plan[
        "bn"]


@pytest.mark.parametrize("m,n,k", PLAN_SHAPES)
def test_gemm_plan_fits_the_card(m, n, k):
    """Shared memory within a block's 232,448 bytes; one block an SM, so
    the grid is at most 132 (and never more blocks than tiles)."""
    plan = tgemm.gemm_plan(m, n, k)
    blocks_per_sm = MAX_SMEM // plan["smem"]
    assert plan["smem"] <= MAX_SMEM and blocks_per_sm == 1
    assert plan["grid"] <= H100_SMS * blocks_per_sm
    assert plan["grid"] == min(plan["tiles"], H100_SMS)
    assert plan["threads"] == 384 and plan["stages"] >= 3


def test_gemm_plan_raster_groups_m_tiles():
    """At QKV's M 25,600 (200 m-tiles, 9 n-tiles) the first 72 tiles are 8
    m-tiles sweeping every n-tile, m fastest, so the 132 tiles in flight
    share their A and W tiles in L2."""
    plan = tgemm.gemm_plan(25600, 2304, 768)
    assert (plan["tiles_m"], plan["tiles_n"], plan["grid"]) == (200, 9, 132)
    first = [tgemm.gemm_tile(plan, t) for t in range(72)]
    assert {m0 for m0, _ in first} == {i * 128 for i in range(8)}
    assert first[:3] == [(0, 0), (128, 0), (256, 0)]
    assert first[8] == (0, 256)


@pytest.mark.parametrize("n,k,dtype,limit", [
    (12, 64, torch.bfloat16, "multiples of 8"),
    (64, 12, torch.bfloat16, "multiples of 8"),
    (780, 72, torch.bfloat16, "multiples of 8"),
    (10, 64, torch.float32, "multiples of 4"),
    (64, 6, torch.float32, "multiples of 4")])
def test_unaligned_n_or_k_raises_naming_the_limit(n, k, dtype, limit):
    with pytest.raises(ValueError, match=limit):
        tgemm.check_shape(130, n, k, dtype)
    if dtype == torch.bfloat16:
        with pytest.raises(ValueError, match=limit):
            tgemm.gemm_plan(130, n, k)


def _np_gelu(x, approximate):
    if approximate:
        return x * (0.5 * (1.0 + np.tanh(np.float32(0.7978845608028654) * (
            x + np.float32(0.044715) * (x * x * x)))))
    erf = np.vectorize(math.erf, otypes=[np.float64])
    return (0.5 * x * (1.0 + erf(x / math.sqrt(2.0)))).astype(np.float32)


def _np_epilogue(a, w, bias, r, epilogue, round_):
    """The epilogue in numpy f32 on the exact f32 products, each output
    rounded once by ``round_`` (the H before the GELU reads it)."""
    acc = a.astype(np.float32) @ w.astype(np.float32)
    if epilogue == "bias":
        return round_(acc + bias)
    if epilogue == "bias_gelu":
        return round_(_np_gelu(acc + bias, True))
    if epilogue == "bias_residual":
        return round_((r + acc) + bias)
    h = round_(acc + bias)
    return round_(_np_gelu(h, epilogue == "bias_hgelu_tanh")), h


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("epilogue", tgemm.EPILOGUES)
def test_gemm_plain_epilogues_match_a_numpy_formula(dtype, epilogue):
    """gemm_plain (and the CPU wrapper, which runs it) against numpy f32
    on the same inputs: bf16 outputs within one bf16 ulp of the output's
    magnitude (the f32 sums may round to the other neighbour), f32 within
    1e-5 of it."""
    rng = np.random.default_rng(7)
    m, n, k = 37, 48, 72
    round_ = _bf16 if dtype == torch.bfloat16 else (lambda x: x)
    a = round_(rng.standard_normal((m, k)).astype(np.float32))
    w = round_((rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32))
    bias = (0.1 * rng.standard_normal(n)).astype(np.float32)
    r = round_(rng.standard_normal((m, n)).astype(np.float32))
    res = torch.from_numpy(r).to(dtype) if epilogue == "bias_residual" \
        else None
    args = (torch.from_numpy(a).to(dtype), torch.from_numpy(w).to(dtype),
            torch.from_numpy(bias))
    got = tgemm.gemm_plain(*args, epilogue=epilogue, residual=res)
    n0 = dict(tatt.LAUNCHES)
    via = tgemm.gemm(*args, epilogue=epilogue, residual=res)
    assert tatt.LAUNCHES == n0                       # the CPU: no launch
    want = _np_epilogue(a, w, bias, r, epilogue, round_)
    got = got if isinstance(got, tuple) else (got,)
    via = via if isinstance(via, tuple) else (via,)
    want = want if isinstance(want, tuple) else (want,)
    for g, v, ww in zip(got, via, want):
        assert g.dtype == dtype and tuple(g.shape) == (m, n)
        assert torch.equal(g, v)
        amax = float(np.abs(ww).max())
        tol = (2.0 ** (math.floor(math.log2(amax)) - 7)
               if dtype == torch.bfloat16 else 1e-5 * amax)
        assert float(np.abs(g.float().numpy() - ww).max()) <= tol


def test_gemm_wrapper_rejects_bad_arguments_on_cpu():
    a, w, bias = torch.zeros(4, 8), torch.zeros(8, 8), torch.zeros(8)
    with pytest.raises(ValueError, match="not one of"):
        tgemm.gemm(a, w, bias, epilogue="relu")
    with pytest.raises(ValueError, match="residual"):
        tgemm.gemm(a, w, bias, epilogue="bias_residual")
    with pytest.raises(ValueError, match="residual"):
        tgemm.gemm(a, w, bias, residual=torch.zeros(4, 8))
