"""The launch plans of kernels 2 and 16 on the CPU.

- ``ops/nlm.py::nlm_plan`` (kernel 16, ``csrc/nlm.cu``): every output
  pixel owned by exactly one block and thread, the interior blocks (those
  that stage without clamps) equal to a brute-force clamp check, shared
  memory within a block's 232,448 bytes, a raise that names the limit past
  it; and the register route's indexing emulated in PyTorch (staged tile,
  each thread's clamped rows and column, the neighbours' diff2 by lane,
  the patch sums in order) equal bit for bit to ``nlm_denoise_plain``.
- ``ops/attention.py::mlp_block_plan`` (kernel 2, ``csrc/mlp_block.cu``):
  every row normalized by one LayerNorm block, every output element of fc1
  and fc2 written by one GEMM tile, shared memory within the limit, a raise
  on widths that are not multiples of 8.

The C launchers' own plans are held to these on the card
(``tests/test_torch_kernels_cuda.py``).
"""

import numpy as np
import pytest
import torch

from vit_spoof_detection_pda_tpu_torch.ops import attention as tatt
from vit_spoof_detection_pda_tpu_torch.ops import gemm as tgemm
from vit_spoof_detection_pda_tpu_torch.ops import nlm as tnlm

# (h, w, c, r, p): the eval shape, ragged and tiny images (smaller than the
# search window), r 0 / p 0, every channel count, both routes, and a
# search radius whose staged tile nears the shared-memory limit
NLM_SHAPES = [(224, 224, 3, 5, 1), (250, 190, 3, 5, 1), (6, 9, 3, 5, 1),
              (20, 17, 1, 2, 2), (224, 224, 3, 0, 0), (33, 31, 2, 0, 1),
              (80, 70, 4, 3, 1), (97, 133, 1, 5, 1), (64, 64, 3, 5, 3),
              (40, 35, 2, 4, 5), (1, 1, 3, 5, 1), (300, 31, 3, 5, 2),
              (512, 512, 4, 40, 1), (96, 96, 3, 11, 0)]


def _blocks(plan):
    return [(bx, by) for by in range(plan["grid_y"])
            for bx in range(plan["grid_x"])]


@pytest.mark.parametrize("h,w,c,r,p", NLM_SHAPES)
def test_nlm_plan_covers_every_pixel_once(h, w, c, r, p):
    plan = tnlm.nlm_plan(h, w, c, r, p)
    assert plan["route"] == ("register" if p <= tnlm.MAX_REG_P else "staged")
    cover = np.zeros((h, w), np.int32)
    tw, th = plan["tile_w"], plan["tile_h"]
    for bx, by in _blocks(plan):
        if plan["route"] == "register":
            assert plan["threads"] == tnlm.LANES * tnlm.WARPS
            # lanes p .. p + tw - 1 of each warp, each warp's 8 rows
            for warp in range(tnlm.WARPS):
                ys = by * th + warp * tnlm.ROWS
                for lane in range(p, p + tw):
                    x = bx * tw - p + lane
                    if x < w:
                        cover[ys:min(ys + tnlm.ROWS, h), x] += 1
        else:
            cover[by * th:(by + 1) * th, bx * tw:(bx + 1) * tw] += 1
    assert (cover == 1).all()
    # no block lies wholly past the image
    assert (plan["grid_x"] - 1) * tw < w and (plan["grid_y"] - 1) * th < h


@pytest.mark.parametrize("h,w,c,r,p", NLM_SHAPES)
def test_nlm_plan_interior_matches_a_clamp_check(h, w, c, r, p):
    """A block is interior exactly when no index it stages is moved by
    the edge clamp."""
    plan = tnlm.nlm_plan(h, w, c, r, p)
    want = set()
    if plan["route"] == "register":
        sw, sh = tnlm.LANES + 2 * r, plan["tile_h"] + 2 * (r + p)
        for bx, by in _blocks(plan):
            xs = bx * plan["tile_w"] - p - r + np.arange(sw)
            ys = by * plan["tile_h"] - p - r + np.arange(sh)
            if ((np.clip(xs, 0, w - 1) == xs).all()
                    and (np.clip(ys, 0, h - 1) == ys).all()):
                want.add((bx, by))
    got = {(bx, by) for bx, by in _blocks(plan)
           if plan["ix0"] <= bx < plan["ix1"]
           and plan["iy0"] <= by < plan["iy1"]}
    assert got == want
    assert plan["interior"] == len(want)


@pytest.mark.parametrize("h,w,c,r,p", NLM_SHAPES)
def test_nlm_plan_shared_memory_fits(h, w, c, r, p):
    plan = tnlm.nlm_plan(h, w, c, r, p)
    if plan["route"] == "register":
        want = (tnlm.LANES + 2 * r) * (plan["tile_h"] + 2 * (r + p)) * c * 4
    else:
        sw, dw = plan["tile_w"] + 2 * (r + p), plan["tile_w"] + 2 * p
        want = 4 * (sw * sw * c + dw * dw)
    assert plan["smem"] == want <= tnlm.MAX_SMEM == 232448


@pytest.mark.parametrize("c,r,p", [(4, 60, 1), (3, 70, 0), (1, 110, 2),
                                   (4, 50, 9)])
def test_nlm_plan_past_the_shared_memory_raises(c, r, p):
    with pytest.raises(ValueError, match="232448"):
        tnlm.nlm_plan(224, 224, c, r, p)


@pytest.mark.parametrize("c", [1, 2, 3, 4])
@pytest.mark.parametrize("p", [0, 1, 2, 3])
def test_nlm_plan_divides_fast_only_by_odd_or_power_of_two_norms(c, p):
    """The register route's multiply-and-correct division is exact for an
    odd norm (2p + 1)^2 C or a power of two, and only there."""
    norm = (2 * p + 1) ** 2 * c
    fast = tnlm.nlm_plan(64, 64, c, 2, p)["fast_div"]
    assert fast == int(p <= tnlm.MAX_REG_P
                       and (norm % 2 == 1 or norm & (norm - 1) == 0))


def test_nlm_plan_rejects_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="1-4 channels"):
        tnlm.nlm_plan(8, 8, 5, 1, 1)
    with pytest.raises(ValueError, match="65535"):
        tnlm.nlm_plan(32 * 65536, 4, 1, 0, 0)
    with pytest.raises(ValueError, match="r and p"):
        tnlm.nlm_plan(8, 8, 3, -1, 1)


def _register_route(img, r, p, h_=0.1, sigma=0.04):
    """The register route of ``csrc/nlm.cu`` emulated block by block: the
    staged tile edge-clamped once, each lane's clamped column and each
    thread's clamped rows, diff2 per offset from the staged tile, the
    neighbours' columns by lane (wrapped at the warp's ends), the patch
    summed rows first, each row from the left, and only lanes p .. 31 - p
    storing."""
    b, h, w, c = img.shape
    plan = tnlm.nlm_plan(h, w, c, r, p)
    tw, th, lanes, rows = plan["tile_w"], plan["tile_h"], tnlm.LANES, tnlm.ROWS
    norm = float((2 * p + 1) ** 2 * c)
    two_sigma2, inv_h2 = 2.0 * sigma * sigma, 1.0 / (h_ * h_)
    out = torch.full_like(img, float("nan"))
    lane = torch.arange(lanes)
    for bx, by in _blocks(plan):
        x0, y0 = bx * tw, by * th
        sx0, sy0 = x0 - p - r, y0 - p - r
        sw, sh = lanes + 2 * r, th + 2 * (r + p)
        stage = img[:, (sy0 + torch.arange(sh)).clamp(0, h - 1)][
            :, :, (sx0 + torch.arange(sw)).clamp(0, w - 1)]
        qx = (x0 - p + lane).clamp(0, w - 1) - sx0                  # [32]
        for warp in range(tnlm.WARPS):
            ys = y0 + warp * rows
            qy = (ys - p + torch.arange(rows + 2 * p)).clamp(0, h - 1) - sy0
            ctr = stage[:, qy][:, :, qx]                  # [b, rows+2p, 32, c]
            acc = torch.zeros(b, rows, lanes, c)
            wsum = torch.zeros(b, rows, lanes)
            for dy in range(-r, r + 1):
                for dx in range(-r, r + 1):
                    s = stage[:, qy + dy][:, :, qx + dx]
                    d = ctr - s
                    d2 = torch.zeros_like(d[..., 0])
                    for ch in range(c):
                        d2 = d2 + d[..., ch] * d[..., ch]
                    box = torch.zeros(b, rows, lanes)
                    for a in range(2 * p + 1):
                        for j in range(2 * p + 1):
                            box = box + d2[:, a:a + rows][
                                :, :, (lane + j - p) % lanes]
                    m = torch.clamp_min(box / norm - two_sigma2, 0.0)
                    wt = torch.exp(-m * inv_h2)
                    acc = acc + wt[..., None] * s[:, p:p + rows]
                    wsum = wsum + wt
            res = acc / torch.clamp_min(wsum, 1e-12)[..., None]
            for o in range(rows):
                y = ys + o
                for ln in range(p, p + tw):
                    x = x0 - p + ln
                    if y < h and x < w:
                        out[:, y, x] = res[:, o, ln]
    return out


@pytest.mark.parametrize("h,w,c,r,p", [(6, 9, 3, 5, 1), (20, 17, 1, 2, 2),
                                       (80, 70, 4, 3, 1), (10, 12, 2, 0, 0),
                                       (40, 33, 3, 2, 1)])
def test_nlm_register_route_indexing_matches_plain(h, w, c, r, p):
    """At tiny sizes (each with edge blocks; 80 x 70 also with an interior
    one) the emulated register route equals the plain version bit for
    bit: its clamps, halos and lane wraps change no value."""
    img = torch.from_numpy(np.random.default_rng(h * w + c).random(
        (2, h, w, c), dtype=np.float32))
    got = _register_route(img, r, p)
    want = tnlm.nlm_denoise_plain(img, search_radius=r, patch_radius=p)
    assert torch.equal(got, want)


MLP_SHAPES = [(1, 768, 3072), (127, 768, 3072), (129, 768, 3072),
              (25216, 768, 3072), (25600, 768, 3072), (80, 64, 256),
              (66, 40, 72)]


@pytest.mark.parametrize("rows,d,hidden", MLP_SHAPES)
def test_mlp_plan_covers_every_row_once(rows, d, hidden):
    plan = tatt.mlp_block_plan(rows, d, hidden)
    assert plan["launches"] == ("ln", "fc1", "fc2")
    ln = plan["ln"]
    cover = np.zeros(rows, np.int32)
    for blk in range(ln["blocks"]):
        lo = blk * ln["rows_per_block"]
        cover[lo:lo + ln["rows_per_block"]] += 1
    assert (cover == 1).all() and ln["threads"] == 32 * ln["rows_per_block"]
    for name, n in (("fc1", hidden), ("fc2", d)):
        g = plan[name]
        tiles = np.zeros((g["tiles_m"], g["tiles_n"]), np.int32)
        for blk in range(g["grid"]):
            for t in tgemm.block_tiles(g, blk):
                m0, n0 = tgemm.gemm_tile(g, t)
                tiles[m0 // g["bm"], n0 // g["bn"]] += 1
        assert (tiles == 1).all()
        assert g["tiles_m"] * g["bm"] >= rows > (g["tiles_m"] - 1) * g["bm"]
        assert g["tiles_n"] * g["bn"] >= n > (g["tiles_n"] - 1) * g["bn"]
        assert g["smem"] <= tgemm.MAX_SMEM
    assert plan["scratch"] == {"xn": rows * d * 2, "hidden": rows * hidden * 2}


@pytest.mark.parametrize("d,hidden", [(44, 96), (64, 100), (0, 64)])
def test_mlp_plan_rejects_widths_off_the_8_grid(d, hidden):
    with pytest.raises(ValueError, match="multiples of 8"):
        tatt.mlp_block_plan(8, d, hidden)
