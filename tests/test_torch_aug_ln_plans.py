"""The route plan of the warp tower's scanline pass (kernel 15,
``ops/warp.py::warp_pass_plan``, the mirror of ``csrc/warp_plan.cuh``),
on the CPU: which route and geometry each shape gets, and that the C
header, compiled here with the host's C++ compiler, gives the same plan
for every shape and route.  Kernel 6's grid is one rule in C that reads
the card (``vsd_ln_res_bwd_plan``); the card test
``test_ln_res_bwd_grid_matches_plain_on_card`` holds it."""

import ctypes
import shutil
import subprocess

import pytest
import torch

from vit_spoof_detection_pda_tpu_torch.ops import _build
from vit_spoof_detection_pda_tpu_torch.ops import warp as twarp

BF, F32 = torch.bfloat16, torch.float32


def _plan(b, h, w, c, dtype, along_y):
    return twarp.warp_pass_plan(b, h, w, c, dtype, along_y)


@pytest.mark.parametrize("dtype,along_y,route,lines,smem", [
    # B 128, 224 x 224 x 3: the tower's timed shape
    (BF, False, "rows_staged", 8, 3 * 10768 + 2 * 7184),
    (BF, True, "cols_direct", 8, 10768 + 7184),
    (F32, False, "rows_staged", 4, 3 * 10768 + 2 * 3600),
    (F32, True, "cols_direct", 4, 10768 + 3600),
])
def test_the_towers_shape_takes_the_staged_routes(dtype, along_y, route,
                                                  lines, smem):
    plan = _plan(128, 224, 224, 3, dtype, along_y)
    assert plan == {"route": route, "lines": lines, "smem": smem,
                    "tiles": 128 * 224 // lines}


@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("along_y", [False, True])
@pytest.mark.parametrize("b,h,w,c", [
    (4, 250, 190, 3),       # lines of 1,140 / 2,280 bytes, off the grid
    (3, 64, 48, 1), (3, 64, 48, 2), (3, 64, 48, 4),
    (2, 40, 36, 3), (1, 1, 1, 1), (7, 5, 3, 2)])
def test_small_and_ragged_frames_are_staged(dtype, along_y, b, h, w, c):
    plan = _plan(b, h, w, c, dtype, along_y)
    assert plan["route"] == ("cols_direct" if along_y else "rows_staged")
    lines = plan["lines"]
    assert lines in (1, 2, 4, 8)
    line = w * c * (2 if dtype == BF else 4)
    # the most rows, a power of 2 up to 8, within the stage bytes
    assert lines * line <= twarp.WARP_STAGE_BYTES or lines == 1
    assert lines == 8 or 2 * lines * line > twarp.WARP_STAGE_BYTES
    assert plan["tiles"] == -(-(b * h) // lines)
    assert plan["smem"] <= twarp.WARP_MAX_SMEM


@pytest.mark.parametrize("dtype,along_y,w,lines,route", [
    (BF, False, 1024, 2, "rows_staged"),    # a line of 8 KB (C 4)
    (BF, False, 2048, 1, "rows_staged"),    # 16 KB: one row a tile
    (F32, False, 1500, 1, "rows_staged"),   # 24 KB: 3 x 24 KB + the field
    (F32, False, 2048, 0, "per_pixel"),     # past the shared memory
    (F32, True, 4096, 1, "cols_direct"),    # the output and field rows
    (F32, True, 5000, 0, "per_pixel"),
    (BF, True, 8000, 1, "cols_direct"),
    (BF, True, 9000, 0, "per_pixel"),
])
def test_long_lines_halve_the_rows_then_go_per_pixel(dtype, along_y, w,
                                                     lines, route):
    plan = _plan(2, 3, w, 4, dtype, along_y)
    assert plan["route"] == route and plan["lines"] == lines
    if route == "per_pixel":
        assert plan["smem"] == 0 and plan["tiles"] == -(-(2 * 3 * w) // 256)


def test_the_wide_frame_of_the_card_tests_goes_per_pixel():
    """The card tests' and chip_smoke.py's per-pixel case: lines of 9,000
    pixels x 4 channels past the staged routes, in both types and both
    directions."""
    for dtype in (BF, F32):
        for along_y in (False, True):
            assert _plan(1, 3, 9000, 4, dtype, along_y)["route"] == \
                "per_pixel"


@pytest.mark.parametrize("along_y", [False, True])
def test_a_cpu_tensor_runs_the_plain_version(along_y):
    g = torch.Generator().manual_seed(0)
    img = torch.rand((2, 9, 7, 3), generator=g)
    field = (torch.rand((2, 9, 7), generator=g) * 2 - 1) * 3
    assert torch.equal(twarp.warp_pass(img, field, 4, along_y=along_y),
                       twarp.warp_pass_plain(img, field, 4, along_y=along_y))


_SHIM = r"""
#include "warp_plan.cuh"
extern "C" void plan(int b, int h, int w, int c, int itemsize, int along_y,
                     long long* out) {
  const vsd::WarpPlan p = vsd::warp_pass_plan(b, h, w, c, itemsize, along_y);
  out[0] = p.route; out[1] = p.lines; out[2] = p.smem; out[3] = p.tiles;
}
"""


@pytest.fixture(scope="module")
def c_plan(tmp_path_factory):
    """``warp_plan.cuh`` compiled for the host, as a Python function."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build csrc/warp_plan.cuh")
    d = tmp_path_factory.mktemp("warp_plan")
    (d / "shim.cpp").write_text(_SHIM)
    subprocess.run([cxx, "-std=c++17", "-shared", "-fPIC", "-O1",
                    "-I", str(_build.CSRC), "-o", str(d / "libplan.so"),
                    str(d / "shim.cpp")], check=True, capture_output=True)
    fn = ctypes.CDLL(str(d / "libplan.so")).plan
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = None

    def run(b, h, w, c, dtype, along_y):
        out = (ctypes.c_longlong * 4)()
        fn(b, h, w, c, 2 if dtype == BF else 4, int(along_y),
           ctypes.addressof(out))
        return {"route": twarp.WARP_ROUTES[out[0]], "lines": out[1],
                "smem": out[2], "tiles": out[3]}
    return run


@pytest.mark.parametrize("c", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("along_y", [False, True])
def test_the_c_header_gives_the_same_plan(c_plan, c, dtype, along_y):
    """Frames from 1 x 1 to past the staged routes, batch 1 to 256."""
    for b in (1, 3, 128, 256):
        for h in (1, 3, 31, 190, 224, 250, 384, 700):
            for w in (1, 29, 64, 190, 224, 250, 384, 1000, 1500, 2048,
                      3000, 4096, 5000, 6000, 8000, 9000, 20000):
                assert c_plan(b, h, w, c, dtype, along_y) == _plan(
                    b, h, w, c, dtype, along_y), (b, h, w)
