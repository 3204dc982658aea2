"""The launch plan of the whole-encoder kernels (ops/lowlat.py
``lowlat_plan``, the mirror of csrc/lowlat_core.cuh make_plan), on the CPU:
every weight tile of every GEMM phase goes to exactly one unit for each
(m-tile, k-tile), the K slices cover K exactly, the scratch fits what the
wrappers allocate, and a traced launch writes 1 + 4 + one stamp a phase.
The card test ``test_lowlat_plan_matches_the_c_launcher_on_card`` holds
the plan to the C launcher's own choice."""

import pytest
import torch

from vit_spoof_detection_pda_tpu_torch.ops import lowlat as tlow

SMS = 132          # the H100 SXM's SMs
MAX_SMEM = 232448  # dynamic shared memory a block may ask for
TPS = list(range(8, 209, 8)) + [584]   # Tp 8-208, and ViT-B/16 at 384 px


def _plans(kernel, b, d=768, heads=12, int8=False):
    for tp in TPS:
        yield tp, tlow.lowlat_plan(b, tp, d, heads, SMS, kernel, int8,
                                   depth=12,
                                   hh=512 if kernel == "lowlat_e2e" else 0)


def _covers_once(g):
    """Each (slab, m-tile, k-tile) of a GEMM plan in exactly one unit."""
    seen = {}
    for slab, mts, kts in tlow.gemm_units(g):
        assert 0 <= slab < g["slabs"] and len(mts) <= 2
        for mt in mts:
            for kt in kts:
                seen[(slab, mt, kt)] = seen.get((slab, mt, kt), 0) + 1
    want = {(s, m, k) for s in range(g["slabs"]) for m in range(g["mtiles"])
            for k in range(g["ktiles"])}
    assert set(seen) == want and set(seen.values()) == {1}


@pytest.mark.parametrize("b", [1, 2, 3, 4])
@pytest.mark.parametrize("kernel,int8", [
    ("lowlat_encoder", False), ("lowlat_encoder", True),
    ("lowlat_e2e", False), ("lowlat_e2e", True), ("lowlat_batchgrid", False)])
def test_every_weight_tile_goes_to_one_unit_per_k_slice(kernel, int8, b):
    for tp, plan in _plans(kernel, b, int8=int8):
        m = b * tp
        for name, g in plan["gemms"].items():
            if g is None:
                assert name == "stem" and kernel != "lowlat_e2e"
                continue
            assert g["mtiles"] == -(-m // 64)
            _covers_once(g)
            # the K slices of one (slab, m-group) tile its k-tiles exactly
            for slab in range(g["slabs"]):
                for mg in range(g["mgroups"]):
                    ks = [kts for s, mts, kts in tlow.gemm_units(g)
                          if s == slab and mts.start == mg * g["mtpg"]]
                    assert len(ks) == g["ksplit"]
                    assert [k for r in ks for k in r] == list(
                        range(g["ktiles"]))
            assert g["units"] == g["slabs"] * g["mgroups"] * g["ksplit"]
            assert g["ksplit"] <= 8 and g["mtpg"] <= 2
            if name not in ("proj", "fc2"):    # no row phase to sum slices
                assert g["ksplit"] == 1


@pytest.mark.parametrize("b", [1, 2, 3, 4])
@pytest.mark.parametrize("kernel", ["lowlat_encoder", "lowlat_e2e",
                                    "lowlat_batchgrid"])
def test_scratch_and_trace_fit_what_the_wrappers_allocate(kernel, b):
    for tp, plan in _plans(kernel, b):
        m, d, dh = b * tp, 768, 64
        slots = [plan["gemms"][k]["ksplit"] for k in ("proj", "fc2")]
        assert plan["splitk_floats"] == max(slots) * m * d
        bar, splitk = tlow._sync_scratch(plan, "cpu")
        assert bar.numel() == plan["bar_words"] == 1 + b
        assert splitk.numel() >= plan["splitk_floats"]
        assert splitk.dtype == torch.float32 and bar.dtype == torch.int32
        assert plan["smem"] <= MAX_SMEM and plan["grid"] == SMS
        # attention: K and V of a key tile and the warps' partials fit
        # the A region; the tiles cover every key
        att = plan["attention"]
        keys = -(-tp // 16) * 16
        assert att["key_tile"] * att["key_tiles"] >= keys
        assert (2 * att["key_tile"] * (dh + 8) * 2
                + 2 * 4 * 16 * (dh + 2) * 4) <= tlow._A_REGION
        assert att["chunks"] * att["gpc"] * 16 >= tp
        assert att["units"] == b * 12 * att["chunks"]
        # a traced launch: the start, 4 bare barriers, a stamp a phase
        names = [ph["name"] for ph in plan["phases"]]
        assert plan["trace_slots"] == 1 + 4 + len(names)
        assert plan["trace_slots"] == tlow.trace_slots(
            12, fold_ends=kernel == "lowlat_e2e")
        assert names[-1] == ("head" if kernel == "lowlat_e2e" else "fixup")
        assert names[1 if kernel == "lowlat_e2e" else 0:-1] == list(
            tlow.LAYER_PHASES) * 12
        assert tlow.unit_trace_slots(plan) == plan["trace_slots"] * (
            1 + SMS * 6)


@pytest.mark.parametrize("d,heads", [(64, 4), (96, 3), (768, 48),
                                     (768, 24)])
def test_plan_at_other_widths_and_head_dims(d, heads):
    """D 64 and 96 (a K chunk of 96: a 64-deep and a 32-deep k-tile), head
    dims 16 and 32 at ViT-B width: the same coverage, and the key tile
    at each head dim."""
    for kernel in ("lowlat_encoder", "lowlat_batchgrid"):
        for tp, plan in _plans(kernel, 3, d=d, heads=heads):
            for g in plan["gemms"].values():
                if g is not None:
                    _covers_once(g)
            assert plan["gemms"]["fc2"]["ktiles"] == 4 * -(-d // 64)
            dh = d // heads
            att = plan["attention"]
            assert (2 * att["key_tile"] * (dh + 8) * 2
                    + 2 * 4 * 16 * (dh + 2) * 4) <= tlow._A_REGION


def test_plan_ints_lay_out_every_gemm_and_the_scratch():
    plan = tlow.lowlat_plan(1, 200, 768, 12, SMS, "lowlat_e2e", hh=512)
    ints = tlow.plan_ints(plan)
    assert len(ints) == 6 + 5 * 6 + 8
    assert ints[:6] == [SMS, 384, plan["smem"], 16, 6, 86]
    assert ints[-2:] == [plan["splitk_floats"], 2]
    # no stem without fold-ends
    enc = tlow.plan_ints(tlow.lowlat_plan(1, 200, 768, 12, SMS,
                                          "lowlat_encoder"))
    assert enc[6:12] == [0] * 6 and enc[5] == 85
    with pytest.raises(ValueError, match="kernel"):
        tlow.lowlat_plan(1, 200, 768, 12, SMS, "lowlat")
