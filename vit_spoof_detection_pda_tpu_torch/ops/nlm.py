"""Fast non-local-means denoise (counterpart of the JAX package's
``ops/nlm.py``): the optional denoise stage of ``ops.image.preprocess_eval``.

For every offset of a ``(2r + 1)^2`` search window the patch distance
between a pixel and its shifted counterpart is a box sum of the
pointwise squared difference; weights ``w = exp(-max(d2 - 2 sigma^2, 0) /
h^2)`` (Buades et al., with the box-filter trick).  Borders clamp: the
shifted source and the patch window both read edge-clamped pixels.

On a CUDA tensor :func:`fast_nlm_denoise` launches the hand-written kernel
``csrc/nlm.cu`` (it replaces the TPU kernel ``ops/nlm_pallas.py::
_nlm_kernel``) for any H x W, on the route :func:`nlm_plan` gives the
shape: ``"register"`` (patch radius <= 2: register tiles, diff2 of each
offset in registers, no barrier in the offset loop; blocks whose staged
tile lies inside the image stage it without clamps) or ``"staged"``
(larger patches: diff2 of each offset through shared memory).  The TPU's
VMEM gate and one-hot shift matmuls were Mosaic workarounds and are not
ported.  On a CPU tensor it runs :func:`nlm_denoise_plain`, which follows
the kernel's arithmetic order: direct patch sums (the JAX XLA form's
``_box_filter`` takes differences of cumulative sums, which round
differently at 224^2).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

LAUNCHES = _build.LAUNCHES
_F = ctypes.c_float
_I = ctypes.c_int
_SIGNATURE = ("vsd_nlm", [ctypes.c_void_p] * 2 + [_I] * 6 + [_F] * 3
              + [ctypes.c_void_p])
_PLAN_SIGNATURE = ("vsd_nlm_plan", [_I] * 5 + [ctypes.POINTER(_I), _I])

# the routes of kernel 16, in the ids of csrc/nlm.cu
NLM_ROUTES = ("register", "staged")
MAX_SMEM = 232448              # dynamic shared memory one H100 block may use
LANES, ROWS, WARPS = 32, 8, 4  # the register route: a warp's columns, a
MAX_REG_P = 2                  # thread's rows, a block's warps; its patches
STAGED_TILE = 16               # the staged route's square tile
_PLAN_KEYS = ("route", "tile_w", "tile_h", "grid_x", "grid_y", "threads",
              "smem", "ix0", "ix1", "iy0", "iy1", "fast_div")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def nlm_plan(h: int, w: int, c: int, r: int, p: int) -> dict:
    """Kernel 16's launch for an ``h`` x ``w`` x ``c`` image, search
    radius ``r``, patch radius ``p``, as ``csrc/nlm.cu::nlm_plan`` chooses
    it: the route (:data:`NLM_ROUTES`), the output tile each block owns
    (``tile_w`` x ``tile_h``), the grid per image (``grid_x`` x
    ``grid_y``), the block's ``threads`` and dynamic shared memory
    (``smem`` bytes), and the blocks that stage without clamps
    (``interior``: ``bx`` in ``[ix0, ix1)`` and ``by`` in ``[iy0, iy1)``,
    those whose staged tile lies inside the image; none on the staged
    route), and ``fast_div``: 1 where the register route divides the patch
    sums by a multiply and one correction (``nlm_div``, equal to
    ``__fdiv_rn`` at every f32 input for an odd norm ``(2p + 1)^2 C`` or a
    power of two: C 1 or 3, or p 0), else 0 (``__fdiv_rn``).  Raises
    ``ValueError`` naming the limit on a shape the kernel does not take (C
    outside 1-4, shared memory past 232,448 bytes, more than 65,535 row
    tiles)."""
    if not 1 <= c <= 4:
        raise ValueError(f"the NLM kernel takes 1-4 channels; got {c}")
    if h <= 0 or w <= 0 or r < 0 or p < 0:
        raise ValueError(f"NLM shape {h} x {w}, r {r}, p {p}: H and W must "
                         "be > 0, r and p >= 0")
    if p <= MAX_REG_P:
        tw, th, threads = LANES - 2 * p, ROWS * WARPS, LANES * WARPS
        smem = (LANES + 2 * r) * (th + 2 * (r + p)) * c * 4
        gx, gy = _cdiv(w, tw), _cdiv(h, th)
        ix0, ix1 = _cdiv(p + r, tw), (w - LANES + p - r) // tw + 1
        iy0, iy1 = _cdiv(p + r, th), (h - th - p - r) // th + 1
        ix1, iy1 = min(max(ix1, 0), gx), min(max(iy1, 0), gy)
        if ix1 < ix0 or ix0 > gx:
            ix0 = ix1 = 0
        if iy1 < iy0 or iy0 > gy:
            iy0 = iy1 = 0
        route = "register"
        fast_div = int(c in (1, 3) or p == 0)
    else:
        tw = th = STAGED_TILE
        threads = STAGED_TILE * STAGED_TILE
        sw, dw = STAGED_TILE + 2 * (r + p), STAGED_TILE + 2 * p
        smem = 4 * (sw * sw * c + dw * dw)
        gx, gy = _cdiv(w, tw), _cdiv(h, th)
        ix0 = ix1 = iy0 = iy1 = fast_div = 0
        route = "staged"
    if smem > MAX_SMEM:
        raise ValueError(f"NLM at r {r}, p {p}, {c} channels needs {smem} "
                         f"bytes of shared memory a block on the {route} "
                         f"route; an H100 block has at most {MAX_SMEM}")
    if gy > 65535:
        raise ValueError(f"NLM at height {h} needs {gy} row tiles; the grid "
                         "takes at most 65535")
    return {"route": route, "tile_w": tw, "tile_h": th, "grid_x": gx,
            "grid_y": gy, "threads": threads, "smem": smem,
            "ix0": ix0, "ix1": ix1, "iy0": iy0, "iy1": iy1,
            "fast_div": fast_div, "interior": (ix1 - ix0) * (iy1 - iy0)}


def nlm_c_plan(h: int, w: int, c: int, r: int, p: int) -> dict:
    """The C launcher's own plan (``vsd_nlm_plan``) in the form of
    :func:`nlm_plan` (a shared memory past the limit reads as 232,449);
    builds the library."""
    lib, fn = _build.entry("nlm", *_PLAN_SIGNATURE)
    out = (_I * len(_PLAN_KEYS))()
    n_out = fn(h, w, c, r, p, out, len(_PLAN_KEYS))
    if n_out != len(_PLAN_KEYS):
        raise RuntimeError(f"vsd_nlm_plan returned {n_out} values")
    plan = dict(zip(_PLAN_KEYS, out))
    plan["route"] = NLM_ROUTES[plan["route"]]
    plan["interior"] = ((plan["ix1"] - plan["ix0"])
                        * (plan["iy1"] - plan["iy0"]))
    return plan


def _edge_pad(x, radius: int, dims=(1, 2)):
    """Edge-pad ``x`` by ``radius`` along ``dims`` (index clamps)."""
    for d in dims:
        n = x.shape[d]
        idx = torch.arange(-radius, n + radius, device=x.device).clamp(0, n - 1)
        x = x.index_select(d, idx)
    return x


def nlm_div_check(norm: float) -> tuple:
    """``(mismatches, first)``: over all 2^32 f32 inputs ``x``, how many
    give another result from the register route's division by ``norm``
    (``csrc/nlm.cu::nlm_div``: a multiply by the correctly rounded
    reciprocal and one FMA correction) than from ``__fdiv_rn`` (two NaNs
    agree), and the least such bit pattern (2^32 where none).  Needs the
    card (``vsd_nlm_div_check``, a few milliseconds)."""
    lib, fn = _build.entry("nlm", "vsd_nlm_div_check",
                           [_F, ctypes.c_void_p, ctypes.c_void_p])
    out = torch.empty(2, dtype=torch.int64, device="cuda")
    _build.check(lib, "nlm_div_check", fn(
        float(norm), out.data_ptr(), torch.cuda.current_stream().cuda_stream))
    count, first = out.tolist()
    return count, first


def nlm_denoise_plain(img, *, h: float = 0.1, sigma: float = 0.04,
                      search_radius: int = 5, patch_radius: int = 1):
    """Plain PyTorch version of the kernel on ``[B, H, W, C]`` f32, in the
    kernel's order: diff2 summed over channels in order, the patch summed
    row by row from 0, f32 divisions."""
    _, hh, ww, cc = img.shape
    r, p = search_radius, patch_radius
    norm = float((2 * p + 1) ** 2 * cc)
    two_sigma2, inv_h2 = 2.0 * sigma * sigma, 1.0 / (h * h)
    padded = _edge_pad(img, r)
    acc = torch.zeros_like(img)
    wsum = torch.zeros_like(img[..., 0])
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            shifted = padded[:, r + dy:r + dy + hh, r + dx:r + dx + ww]
            d = img - shifted
            diff2 = d[..., 0] * d[..., 0]
            for ch in range(1, cc):
                diff2 = diff2 + d[..., ch] * d[..., ch]
            dp = _edge_pad(diff2, p)
            box = torch.zeros_like(diff2)
            for i in range(2 * p + 1):
                for j in range(2 * p + 1):
                    box = box + dp[:, i:i + hh, j:j + ww]
            m = torch.clamp_min(box / norm - two_sigma2, 0.0)
            w = torch.exp(-m * inv_h2)
            acc = acc + w[..., None] * shifted
            wsum = wsum + w
    return acc / torch.clamp_min(wsum, 1e-12)[..., None]


def nlm_denoise(img, *, h: float = 0.1, sigma: float = 0.04,
                search_radius: int = 5, patch_radius: int = 1):
    """``[B, H, W, C]`` f32 -> denoised: one launch of ``csrc/nlm.cu`` on a
    CUDA tensor (C <= 4; the route of :func:`nlm_plan`),
    :func:`nlm_denoise_plain` on a CPU tensor."""
    if img.device.type == "cpu":
        return nlm_denoise_plain(img, h=h, sigma=sigma,
                                 search_radius=search_radius,
                                 patch_radius=patch_radius)
    if img.device.type != "cuda":
        raise ValueError(f"no kernel for device {img.device}")
    b, hh, ww, cc = img.shape
    if img.dtype != torch.float32:
        raise TypeError(f"img is {img.dtype}; the kernel takes float32")
    if not 1 <= cc <= 4:
        raise ValueError(f"the NLM kernel takes 1-4 channels; got {cc}")
    if b > 65535:
        raise ValueError(f"the NLM kernel takes at most 65535 images; got {b}")
    nlm_plan(hh, ww, cc, search_radius, patch_radius)   # raises past a limit
    img = img.contiguous()
    out = torch.empty_like(img)
    p = patch_radius
    lib, fn = _build.entry("nlm", *_SIGNATURE)
    err = fn(img.data_ptr(), out.data_ptr(), b, hh, ww, cc, search_radius, p,
             2.0 * sigma * sigma, 1.0 / (h * h), float((2 * p + 1) ** 2 * cc),
             torch.cuda.current_stream(img.device).cuda_stream)
    _build.check(lib, "nlm", err)
    LAUNCHES["nlm"] += 1
    return out


def fast_nlm_denoise(img, *, h: float = 0.1, sigma: float = 0.04,
                     search_radius: int = 5, patch_radius: int = 1):
    """Denoise NHWC or HWC float images in [0, 1] (defaults: 11 x 11
    search, 3 x 3 patches; h and sigma in [0, 1] intensity units)."""
    single = img.dim() == 3
    x = img[None] if single else img
    out = nlm_denoise(x.float(), h=h, sigma=sigma,
                      search_radius=search_radius,
                      patch_radius=patch_radius).to(img.dtype)
    return out[0] if single else out
