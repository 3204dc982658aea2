"""Every plan function of the port's attention kernels gives a route for
every shape the JAX functions take: bf16 and f32, head dims 16 to 128 in
steps of 16, Tp from 8 to 1,040 (ViT-B/16 at 512 px) at and around each
limit a one-block form had, with the block's shared memory within the
H100's 232,448 bytes.  The plans choose a route by shape before any
launch, so they run here on the CPU."""

from pathlib import Path

import pytest
import torch

from vit_spoof_detection_pda_tpu_torch.ops import attention as tatt

MAX_SMEM = 232448
BF, F32 = torch.bfloat16, torch.float32
# every multiple of 8 up to 1,040, and the odd Tp at and around each old
# limit (kernel 4: 208 / 264; kernel 5: 208 / 256; the f32 core: 333 / 328;
# the bf16 core and kernel 12: 208, 384, 800; kernel 13: 256; the old long
# route: 908)
TPS = sorted(set(range(8, 1041, 8)) | {
    1, 9, 197, 201, 207, 209, 255, 257, 263, 265, 329, 333, 334, 335, 383,
    385, 577, 799, 801, 907, 909, 1025, 1039})
HEAD_DIMS = range(16, 129, 16)
ROUTES = {"unphased", "on_chip", "key_tiled"}
FORMS = {"one_pass", "two_pass", "key_tiled", "whole"}

PLANS = {
    "attention_qkv_bwd_plan":
        lambda tp, dh, dt: tatt.attention_qkv_bwd_plan(8, tp, 12, dh, dt),
    "phased_plan": lambda tp, dh, dt: tatt.phased_plan(8, tp, 12, dh, dt),
    # the 2-rank sequence-parallel block: Tq half the keys, and Tq = Tk
    "cp_plan": lambda tp, dh, dt: [tatt.cp_plan(-(-tp // 2), tp, dh, dt),
                                   tatt.cp_plan(tp, tp, dh, dt)],
    "cp_bwd_plan": lambda tp, dh, dt: [
        tatt.cp_bwd_plan(8, -(-tp // 2), tp, 12, dh, dt),
        tatt.cp_bwd_plan(8, tp, tp, 12, dh, dt)],
    "module_attention_plan":
        lambda tp, dh, dt: tatt.module_attention_plan(tp, dh, dt),
}
CASES = [(name, dt) for name in PLANS for dt in (BF, F32)]


@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("name,dtype", CASES)
def test_every_plan_has_a_route_up_to_tp_1040(name, dtype, dh):
    for tp in TPS:
        plans = PLANS[name](tp, dh, dtype)
        for plan in plans if isinstance(plans, list) else [plans]:
            assert plan.get("route") in ROUTES or plan.get("form") in FORMS, (
                name, tp, plan)
            assert 0 < plan["smem"] <= MAX_SMEM, (name, tp, plan)


@pytest.mark.parametrize("dtype", [BF, F32])
def test_module_attention_plan_is_one_pass_up_to_208_keys(dtype):
    """Kernels 8 and 9 run kernel 12's one-pass core at ViT-B/16's T 197
    (two query tiles: 7 warps of 16 rows in bf16, 8 row groups of two
    warps in f32) and up to the 208 keys it holds; T 209 takes another
    route."""
    plan = tatt.module_attention_plan(197, 64, dtype)
    assert plan == tatt.cp_plan(197, 197, 64, dtype)
    assert (plan["form"], plan["tiles"]) == ("one_pass", 2)
    # keys rounded up to 16 rows (bf16) or 8 (f32)
    assert (plan["warps"], plan["keys"]) == ((7, 208) if dtype == BF
                                             else (16, 200))
    assert tatt.module_attention_plan(208, 64, dtype)["form"] == "one_pass"
    # past it, the routes timed fastest: kernel 12's two passes in bf16,
    # the whole f32 core in f32
    assert tatt.module_attention_plan(209, 64, dtype)["form"] == (
        "two_pass" if dtype == BF else "whole")


@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_module_attention_plan_bf16_is_kernel_12s(dh):
    """In bf16, kernels 8 and 9 run kernel 12's forms at Tq = Tk = T at
    every T: one pass, two passes with K and V whole, then key tiles."""
    for t in TPS:
        assert tatt.module_attention_plan(t, dh, BF) == tatt.cp_plan(
            t, t, dh, BF)


@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [BF, F32])
def test_module_attention_plan_tiles_cover_every_row(dtype, dh):
    """Every route of kernel 12's that kernels 8 and 9 take covers the T
    rows with its query tiles (16-row groups over the block's warps: one
    a group, or two in the f32 one-pass form); past the f32 one pass they
    take the f32 blocks' routes, whose grids the f32 core sets itself."""
    for t in TPS:
        plan = tatt.module_attention_plan(t, dh, dtype)
        if dtype == F32 and plan["form"] != "one_pass":
            assert plan == tatt._f32_core_plan(t, dh), (t, plan)
            assert plan["form"] in ("whole", "key_tiled"), (t, plan)
            continue
        per_group = 2 if dtype == F32 else 1
        assert plan["tiles"] * plan["warps"] >= per_group * -(-t // 16)
        assert plan["warps"] <= (16 if dtype == F32 else 8), (t, plan)


# --------------------------------------------------------------------------
# The attention backward (kernels 4, 5 and 13): the one-launch on-chip core
# (csrc/attention_bwd_onchip.cuh) where it holds the head, the key-tiled
# backward past it
# --------------------------------------------------------------------------

SQUARES = range(8, 1041, 8)
# the core's limits: bf16 Tk rounded up to 16 at most 208; f32 Tk by head dim
F32_MAX_KEYS = {16: 576, 32: 448, 64: 320}


def _on_chip(tq: int, tk: int, dh: int, dtype) -> bool:
    """Where the on-chip core holds the head: head dims 16, 32, 64; bf16 at
    most 208 keys with K, V and the [Tq, Tk] bf16 w and dl tiles (and Q, G
    over K, V) in 227 KB; f32 at most 320 / 448 / 576 keys (head dim 64 /
    32 / 16), any Tq."""
    if dh not in (16, 32, 64):
        return False
    if dtype == BF:
        nq, nk = -(-tq // 16) * 16, -(-tk // 16) * 16
        return nk <= 208 and 2 * (2 * max(nq, nk) * dh + 2 * nq * nk) <= MAX_SMEM
    return tk <= F32_MAX_KEYS[dh]


@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [BF, F32])
def test_backward_plans_name_the_core_on_every_square(dtype, dh):
    """Kernels 4 and 5 and kernel 13 at Tq = Tk, Tp 8 to 1,040 in steps of
    8: the core where it holds the head (kernel 4 "unphased", 5 and 13
    "on_chip", with the same instance, warps and shared memory), the
    key-tiled backward everywhere else."""
    for tp in SQUARES:
        p4 = tatt.attention_qkv_bwd_plan(8, tp, 12, dh, dtype)
        p5 = tatt.phased_plan(8, tp, 12, dh, dtype)
        p13 = tatt.cp_bwd_plan(8, tp, tp, 12, dh, dtype)
        if _on_chip(tp, tp, dh, dtype):
            core = tatt.onchip_bwd_plan(tp, tp, dh, dtype)
            assert p4 == {"route": "unphased", **core}, (tp, p4)
            assert p5 == p13 == {"route": "on_chip", **core}, (tp, p5, p13)
        else:
            assert p4 == p5 == p13 == tatt.tiled_bwd_plan(8, 12, dh, dtype), tp


@pytest.mark.parametrize("dtype", [BF, F32])
def test_backward_plans_at_vit_b_shapes(dtype):
    """ViT-B/16 (head dim 64): the core at the training step's Tp 200 and
    the 2-rank block Tq 104 / Tk 208, in the instances a warp holds (bf16:
    7 warps; f32: 256 keys, 8 warps); bf16 Q and G in tiles of their own on
    the rectangle (175 KB) but over K and V on the square (226 KB)."""
    p4 = tatt.attention_qkv_bwd_plan(128, 200, 12, 64, dtype)
    p13 = tatt.cp_bwd_plan(128, 104, 208, 12, 64, dtype)
    if dtype == BF:
        assert p4 == {"route": "unphased", "keys": 208, "warps": 7,
                      "smem": 2 * (2 * 208 * 64 + 2 * 208 * 208)}
        assert p13 == {"route": "on_chip", "keys": 208, "warps": 7,
                       "smem": 2 * (2 * 208 * 64 + 2 * 112 * 208
                                    + 2 * 112 * 64)}
    else:
        assert p4 == {"route": "unphased", "keys": 256, "warps": 8,
                      "smem": 4 * (2 * 200 * 68 + 4 * 16 * 68 + 2 * 16 * 200)}
        assert p13 == {"route": "on_chip", "keys": 256, "warps": 8,
                       "smem": 4 * (2 * 208 * 68 + 4 * 16 * 68 + 2 * 16 * 208)}
    # ViT-B/16 at 256 px (Tp 264): f32 on the core's 320-key instance
    assert tatt.attention_qkv_bwd_plan(32, 264, 12, 64, dtype)["route"] == (
        "key_tiled" if dtype == BF else "unphased")


# the rectangles of sequence parallelism and around the core's limits, and
# the route kernel 13 takes on each at head dim 64, bf16 / f32
RECTS = {(8, 208): ("on_chip", "on_chip"),
         (104, 208): ("on_chip", "on_chip"),
         (56, 224): ("key_tiled", "on_chip"),
         (208, 16): ("on_chip", "on_chip"),
         (200, 264): ("key_tiled", "on_chip"),
         (296, 592): ("key_tiled", "key_tiled")}


@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("tq,tk", list(RECTS))
def test_cp_bwd_plan_names_the_route_on_each_rectangle(tq, tk, dtype, dh):
    plan = tatt.cp_bwd_plan(8, tq, tk, 12, dh, dtype)
    want = "on_chip" if _on_chip(tq, tk, dh, dtype) else "key_tiled"
    assert plan["route"] == want, plan
    if dh == 64:
        assert want == RECTS[tq, tk][dtype == F32]
    if want == "on_chip":
        assert plan == {"route": "on_chip",
                        **tatt.onchip_bwd_plan(tq, tk, dh, dtype)}
        assert 0 < plan["smem"] <= MAX_SMEM
        # part A's row groups and part B's key groups over the block
        assert plan["warps"] == (min(7, max(-(-tq // 16), -(-tk // 16)))
                                 if dtype == BF else 8)


def _parent_on_chip(kernel: str, tq: int, tk: int, dh: int, dtype) -> bool:
    """Where the backward before the on-chip core held the head on chip:
    kernel 4 (bf16 head dims 16 / 32 / 64 with K, V and the [Tp, Tp] bf16
    tiles in shared memory; f32 its two launches, any head dim, while one
    head's K, V, stats and per-warp rows fit), kernel 5 (head dims 16 / 32
    / 64: bf16 at most 208 keys, f32 Tp up to 256), kernel 13 (bf16 as
    kernel 4 with Tq, Tk up to 256; f32 kernel 4's launches at the larger
    of Tq and Tk)."""
    nq, nk = -(-tq // 16) * 16, -(-tk // 16) * 16
    bf_smem = 2 * (2 * max(nq, nk) * dh + 2 * nq * nk)
    t = max(tq, tk)
    f32_smem = 4 * (2 * t * (dh + 4) + 4 * t + 8 * (8 * dh + 8 * t))
    if kernel == "5":
        if dh not in (16, 32, 64):
            return False
        if dtype == BF:
            return nk <= 208 and bf_smem <= MAX_SMEM
        nkp = -(-tk // 4) * 4
        return tk <= 256 and 4 * (2 * nkp * (dh + 4) + 64 * (dh + 4)
                                  + 32 * nkp) <= MAX_SMEM
    if dtype == F32:
        return f32_smem <= MAX_SMEM
    return (dh in (16, 32, 64) and bf_smem <= MAX_SMEM
            and (kernel == "4" or max(nq, nk) <= 256))


# Why a shape the parent held on chip now takes the key-tiled backward:
# each reason is a sentence of PERF.md that gives the measurement.
MOVED = {
    "bf16 past 208 keys": "bf16 past 208 keys go to the key-tiled backward",
    "f32 head dims 48 and 80-128":
        "f32 head dims 48 and 80-128 go to the key-tiled backward",
}


def _why_moved(tq, tk, dh, dtype) -> str:
    if dtype == BF and -(-tk // 16) * 16 > 208:
        return "bf16 past 208 keys"
    if dtype == F32 and dh not in (16, 32, 64):
        return "f32 head dims 48 and 80-128"
    return ""


@pytest.mark.parametrize("dtype", [BF, F32])
def test_no_shape_the_parent_held_moves_to_the_key_tiled_route_unrecorded(
        dtype):
    """Every square Tp 8-1,040 (steps of 8) and every rectangle above, at
    every head dim: a shape the backward held on chip before the on-chip
    core takes the key-tiled backward now only for a reason PERF.md
    records with its measurement."""
    perf = (Path(__file__).resolve().parents[1] / "PERF.md").read_text()
    perf = " ".join(perf.split())
    for reason, sentence in MOVED.items():
        assert sentence in perf, reason
    shapes = [("4", tp, tp) for tp in SQUARES] + [
        ("5", tp, tp) for tp in SQUARES] + [
        ("13", tq, tk) for tq, tk in list(RECTS) + [(tp, tp) for tp in SQUARES]]
    moved = set()
    for dh in HEAD_DIMS:
        for kernel, tq, tk in shapes:
            if kernel == "13":
                route = tatt.cp_bwd_plan(8, tq, tk, 12, dh, dtype)["route"]
            else:
                route = tatt.attention_qkv_bwd_plan(
                    8, tq, 12, dh, dtype)["route"]
            if route == "key_tiled" and _parent_on_chip(kernel, tq, tk, dh,
                                                        dtype):
                why = _why_moved(tq, tk, dh, dtype)
                assert why, (kernel, tq, tk, dh)
                moved.add(why)
    assert moved == ({"bf16 past 208 keys"} if dtype == BF
                     else {"f32 head dims 48 and 80-128"})
