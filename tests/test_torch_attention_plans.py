"""Every plan function of the port's attention kernels gives a route for
every shape the JAX functions take: bf16 and f32, head dims 16 to 128 in
steps of 16, Tp from 8 to 1,040 (ViT-B/16 at 512 px) at and around each
limit a one-block form had, with the block's shared memory within the
H100's 232,448 bytes.  The plans choose a route by shape before any
launch, so they run here on the CPU."""

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
    "forward_plan": lambda tp, dh, dt: tatt.forward_plan(tp, dh, dt),
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
            assert plan == tatt.forward_plan(t, dh, F32), (t, plan)
            continue
        per_group = 2 if dtype == F32 else 1
        assert plan["tiles"] * plan["warps"] >= per_group * -(-t // 16)
        assert plan["warps"] <= (16 if dtype == F32 else 8), (t, plan)
