"""Resampling core of the geometric augmentations (counterpart of the JAX
package's ``ops/warp.py``).

Everything is batched NHWC: images ``[B, H, W, C]``, per-sample
parameters with a leading ``[B]`` axis (angles ``[B]``, homographies
``[B, 3, 3]``, fields ``[B, H, W]``).

Two families, as in the JAX package:

- the scanline passes of the gather-free warp tower (``rotate_3shear``,
  ``perspective_warp_2pass``, ``displacement_warp_2pass``), each pass one
  launch of the hand-written kernel ``csrc/warp_pass.cu`` for the whole
  batch (:func:`warp_pass`), on the route :func:`warp_pass_plan` chooses
  by shape.  It replaces the TPU kernel
  ``ops/warp_pallas.py::_pass_kernel`` and computes what that kernel
  computes: a 2-tap tent in f32, zero fill outside the frame, the output
  in the image's dtype.  On a CPU tensor :func:`warp_pass` runs
  :func:`warp_pass_plain`; on a CUDA tensor it launches the kernel.  The
  port dispatches on the tensor's device (the JAX package's
  ``_use_pallas_rolls`` chose by backend and mesh; the port has no mesh).
- plain PyTorch bilinear sampling (``bilinear_sample``, ``affine_warp``,
  ``perspective_warp``, ``displacement_warp``, ``bilinear_sample_packed``)
  behind the standalone ``random_rotation`` / ``random_perspective`` /
  ``elastic_transform`` and the ``sampler="gather"`` oracle.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

LAUNCHES = _build.LAUNCHES
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURE = ("vsd_warp_pass", [_P] * 3 + [_I] * 4 + [_L] * 3 + [_I] * 3 + [_P])
_PLAN_SIGNATURE = ("vsd_warp_pass_plan", [_I] * 6 + [_P])

# the routes of kernel 15, in the ids of csrc/warp_plan.cuh
WARP_ROUTES = ("per_pixel", "rows_staged", "cols_direct")
WARP_THREADS = 256
WARP_STAGE_BYTES = 16384       # image bytes of the rows a staged block takes
WARP_STAGES = 2                # stages of the rows_staged ring
WARP_MAX_SMEM = 98304          # shared memory past which a pass goes per pixel
_INT32 = 2 ** 31 - 1


# --------------------------------------------------------------------------
# the scanline pass (kernel 15)
# --------------------------------------------------------------------------


def warp_pass_plain(img: torch.Tensor, field: torch.Tensor, kmax: int, *,
                    along_y: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel.

    ``out[b, y, x] = img[b, y, x + f]`` (``along_y=False``) or
    ``img[b, y + f, x]`` (``along_y=True``), ``f = field[b, y, x]``: the
    taps ``k0 = floor(f)`` and ``k0 + 1`` weighted by the tent
    ``max(0, 1 - |f - k|)`` (a tap outside ``[-kmax, kmax]`` has no
    term), summed in that order in f32; zero where ``pos + f`` lies
    outside ``[0, n - 1]``; cast to ``img.dtype``.  A tap index is wrapped
    within the line as the TPU kernel's roll wraps it (its weight is 0
    there in exact arithmetic)."""
    axis = 1 if along_y else 2
    n = img.shape[axis]
    shape = [1, 1, 1]
    shape[axis] = n
    pos = torch.arange(n, dtype=torch.float32, device=img.device).view(shape)
    f = field.float()
    src = pos + f
    valid = (src >= 0.0) & (src <= n - 1)
    k0 = torch.floor(f)
    x = img.float()
    acc = torch.zeros_like(x)
    for d in (0, 1):
        k = k0 + d
        use = valid & (k >= -kmax) & (k <= kmax)
        wt = torch.where(use, torch.clamp_min(1.0 - (f - k).abs(), 0.0), 0.0)
        idx = torch.where(use, pos + k, pos).long().remainder(n)
        idx = idx.unsqueeze(-1).expand_as(x)
        acc = acc + wt.unsqueeze(-1) * torch.gather(x, axis, idx)
    return torch.where(valid.unsqueeze(-1), acc, 0.0).to(img.dtype)


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def warp_pass_plan(b: int, h: int, w: int, c: int, dtype,
                   along_y: bool) -> dict:
    """The route of one pass of kernel 15 and its geometry, chosen by
    shape before any launch (the mirror of ``csrc/warp_plan.cuh``, which
    the launcher runs and ``vsd_warp_pass_plan`` exports).

    ``rows_staged`` (along x) and ``cols_direct`` (along y): a tile is
    ``lines`` whole image rows, the largest power of 2 up to 8 whose rows
    hold at most ``WARP_STAGE_BYTES``, moved through shared memory with
    16-byte copies (along x two stages of input and field rows and one of
    output, a persistent grid of 256-thread blocks walking the ``tiles``;
    along y a block a tile, its field and output rows staged); past
    ``WARP_MAX_SMEM`` of shared memory, or past 32-bit row or image
    indices, ``per_pixel``: one thread a pixel (``tiles`` blocks of 256).

    Returns ``{"route", "lines", "smem", "tiles"}``."""
    plan = {"route": "per_pixel", "lines": 0, "smem": 0,
            "tiles": -(-(b * h * w) // WARP_THREADS)}
    line = w * c * (2 if dtype == torch.bfloat16 else 4)
    lines = 8
    while lines > 1 and lines * line > WARP_STAGE_BYTES:
        lines //= 2
    tile, fbytes = _align16(lines * line + 16), _align16(lines * w * 4 + 16)
    smem = (tile + fbytes if along_y else
            (1 + WARP_STAGES) * tile + WARP_STAGES * fbytes)
    if smem > WARP_MAX_SMEM or b * h > _INT32 or h * w * c > _INT32:
        return plan
    return {"route": "cols_direct" if along_y else "rows_staged",
            "lines": lines, "smem": smem, "tiles": -(-(b * h) // lines)}


def warp_pass_c_plan(b: int, h: int, w: int, c: int, dtype,
                     along_y: bool) -> dict:
    """The C launcher's own plan (``vsd_warp_pass_plan``) in the form of
    :func:`warp_pass_plan`; builds the library."""
    lib, fn = _build.entry("warp_pass", *_PLAN_SIGNATURE)
    out = (ctypes.c_longlong * 4)()
    _build.check(lib, "warp_pass_plan", fn(
        b, h, w, c, int(dtype == torch.bfloat16), int(along_y), out))
    return {"route": WARP_ROUTES[out[0]], "lines": out[1], "smem": out[2],
            "tiles": out[3]}


def warp_pass(img: torch.Tensor, field: torch.Tensor, kmax: int, *,
              along_y: bool = False) -> torch.Tensor:
    """One scanline pass over the batch (see :func:`warp_pass_plain`).

    img    [B, H, W, C] f32 or bf16, C <= 4
    field  [B, H, W] f32; may be a broadcast view (stride 0 on an axis)

    On a CUDA tensor: one launch of ``csrc/warp_pass.cu`` on the route
    :func:`warp_pass_plan` gives the shape; a bad input or a failed build
    or launch raises."""
    if img.device.type == "cpu":
        return warp_pass_plain(img, field, kmax, along_y=along_y)
    if img.device.type != "cuda":
        raise ValueError(f"no kernel for device {img.device}")
    b, h, w, c = img.shape
    if img.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"img is {img.dtype}; the kernel takes float32 or "
                        "bfloat16")
    if not 1 <= c <= 4:
        raise ValueError(f"the warp kernel takes 1-4 channels; got {c}")
    if field.dtype != torch.float32 or tuple(field.shape) != (b, h, w):
        raise ValueError(f"field must be float32 [{b}, {h}, {w}]; got "
                         f"{field.dtype} {tuple(field.shape)}")
    if field.device != img.device:
        raise ValueError(f"field is on {field.device}, expected {img.device}")
    img = img.contiguous()
    out = torch.empty_like(img)
    lib, fn = _build.entry("warp_pass", *_SIGNATURE)
    err = fn(img.data_ptr(), field.data_ptr(), out.data_ptr(), b, h, w, c,
             *field.stride(), int(kmax), int(along_y),
             int(img.dtype == torch.bfloat16),
             torch.cuda.current_stream(img.device.index).cuda_stream)
    _build.check(lib, "warp_pass", err)
    LAUNCHES["warp_pass"] += 1
    return out


def _resample_rows_field(img, shift, kmax: int):
    """``out[b, y, x] = img[b, y, x + shift[b, y, x]]``, zero outside the
    frame (|shift| <= kmax: callers clamp)."""
    return warp_pass(img, shift.float(), kmax, along_y=False)


def _resample_cols_field(img, shift, kmax: int):
    """``out[b, y, x] = img[b, y + shift[b, y, x], x]``."""
    return warp_pass(img, shift.float(), kmax, along_y=True)


def _resample_rows_roll(img, shifts, kmax: int):
    """Per-ROW shift ``[B, H]`` (a broadcast field, not materialized)."""
    b, h, w, _ = img.shape
    return _resample_rows_field(img, shifts[:, :, None].expand(b, h, w), kmax)


def _resample_cols_roll(img, shifts, kmax: int):
    """Per-COLUMN shift ``[B, W]`` along y."""
    b, h, w, _ = img.shape
    return _resample_cols_field(img, shifts[:, None, :].expand(b, h, w), kmax)


# --------------------------------------------------------------------------
# the tower's warps
# --------------------------------------------------------------------------


def _dest_grid(h: int, w: int, dtype=torch.float32, device=None):
    ys = torch.arange(h, dtype=dtype, device=device)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=dtype, device=device)[None, :].expand(h, w)
    return ys, xs


def _guard(den, eps):
    """``den`` with |den| < eps replaced by -eps / +eps by its sign."""
    return torch.where(den.abs() < eps,
                       torch.where(den < 0, -eps, eps).to(den.dtype), den)


def perspective_shift_fields(hm, h: int, w: int):
    """Shift fields ``(fh, fv)``, each ``[B, H, W]``, of the exact two-pass
    (Catmull-Smith) decomposition of the inverse homographies ``hm``
    ``[B, 3, 3]`` (dest -> src): pass 1 ``tmp[t, x] = src[t, x + fh]``,
    pass 2 ``out[y, x] = tmp[y + fv, x]`` (the JAX package's formulas)."""
    ys, xs = _dest_grid(h, w, device=hm.device)
    ys, xs = ys[None], xs[None]
    e3 = hm[:, :, :, None, None]
    a, b, c = e3[:, 0, 0], e3[:, 0, 1], e3[:, 0, 2]
    d, e, f = e3[:, 1, 0], e3[:, 1, 1], e3[:, 1, 2]
    g, h2, i = e3[:, 2, 0], e3[:, 2, 1], e3[:, 2, 2]
    t = ys
    den1 = _guard(e - h2 * t, 1e-6)
    ystar = ((i * t - f) + xs * (g * t - d)) / den1
    den2 = _guard(g * xs + h2 * ystar + i, 1e-8)
    fh = (a * xs + b * ystar + c) / den2 - xs
    den3 = _guard(g * xs + h2 * ys + i, 1e-8)
    fv = (d * xs + e * ys + f) / den3 - ys
    return fh, fv


def perspective_warp_2pass(img, hm, kmax: int = 32):
    """Gather-free perspective warp: two scanline passes over the fields
    of :func:`perspective_shift_fields`, clamped to ``kmax - 1e-3``."""
    h, w = img.shape[1], img.shape[2]
    fh, fv = perspective_shift_fields(hm, h, w)
    lim = float(kmax) - 1e-3
    out = _resample_rows_field(img, fh.clamp(-lim, lim), kmax)
    return _resample_cols_field(out, fv.clamp(-lim, lim), kmax)


def displacement_warp_2pass(img, dy, dx, kmax: int = 8):
    """Gather-free elastic warp: a vertical then a horizontal pass over
    the ``[B, H, W]`` displacement fields, clamped to ``kmax - 1e-3``."""
    lim = float(kmax) - 1e-3
    out = _resample_cols_field(img, dy.clamp(-lim, lim), kmax)
    return _resample_rows_field(out, dx.clamp(-lim, lim), kmax)


def rotate_3shear(img, theta, max_degrees: float):
    """Rotation about the image center by ``theta`` ``[B]`` (radians) as
    the Paeth 3-shear ``ShX(-tan t/2) . ShY(sin t) . ShX(-tan t/2)``:
    three scanline passes, zero fill outside the frame.  ``max_degrees``
    is the static bound on |theta| that sizes the passes' ``kmax``."""
    h, w = img.shape[1], img.shape[2]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    rad = math.radians(max_degrees)
    kx = int(math.ceil(math.tan(rad / 2.0) * max(cy, 1.0))) + 1
    ky = int(math.ceil(math.sin(rad) * max(cx, 1.0))) + 1
    theta = theta.float()
    a = -torch.tan(theta / 2.0)
    b = torch.sin(theta)
    ys = torch.arange(h, dtype=torch.float32, device=img.device) - cy
    xs = torch.arange(w, dtype=torch.float32, device=img.device) - cx
    row_shift = a[:, None] * ys[None, :]
    out = _resample_rows_roll(img, row_shift, kx)
    out = _resample_cols_roll(out, b[:, None] * xs[None, :], ky)
    return _resample_rows_roll(out, row_shift, kx)


# --------------------------------------------------------------------------
# bilinear sampling (plain PyTorch)
# --------------------------------------------------------------------------


def _flat_gather(img, yi, xi):
    """``img[b, yi, xi]`` for index tensors ``[B, ...]`` -> ``[B, ..., C]``."""
    b, h, w, c = img.shape
    flat = img.reshape(b, h * w, c)
    lin = (yi * w + xi).reshape(b, -1)
    out = torch.gather(flat, 1, lin[..., None].expand(-1, -1, c))
    return out.reshape(*yi.shape, c)


def bilinear_sample(img, ys, xs, fill: float = 0.0):
    """Sample ``img`` ``[B, H, W, C]`` at float coordinates ``ys``/``xs``
    ``[B, ...]``, bilinear, ``fill`` outside (grid_sample's
    ``padding_mode='zeros'`` per tap)."""
    h, w = img.shape[1], img.shape[2]
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = (ys - y0)[..., None]
    wx = (xs - x0)[..., None]
    y0i, x0i = y0.long(), x0.long()

    def tap(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        vals = _flat_gather(img, yi.clamp(0, h - 1), xi.clamp(0, w - 1))
        return torch.where(valid[..., None], vals, fill)

    v00, v01 = tap(y0i, x0i), tap(y0i, x0i + 1)
    v10, v11 = tap(y0i + 1, x0i), tap(y0i + 1, x0i + 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def bilinear_sample_packed(img, ys, xs, *, tap_dtype=None, fill: float = 0.0):
    """Bilinear sampling with the four taps read together (the JAX
    package's packed single-gather sampler, ``sampler="gather"``):
    ``tap_dtype`` rounds the taps (bf16 in the tower's oracle), weights
    stay f32; coordinates within one pixel of the frame edge-clamp, the
    rest fills with ``fill``."""
    h, w, c = img.shape[1], img.shape[2], img.shape[3]
    src = img.to(tap_dtype) if tap_dtype is not None else img
    right = torch.cat([src[:, :, 1:], src[:, :, -1:]], dim=2)
    down = torch.cat([src[:, 1:], src[:, -1:]], dim=1)
    diag = torch.cat([right[:, 1:], right[:, -1:]], dim=1)
    pack = torch.cat([src, right, down, diag], dim=-1)
    valid = ((ys >= -1.0) & (ys <= h - 0.0) &
             (xs >= -1.0) & (xs <= w - 0.0))[..., None]
    y0i = torch.floor(ys).long().clamp(0, max(h - 2, 0))
    x0i = torch.floor(xs).long().clamp(0, max(w - 2, 0))
    wy = (ys - y0i).clamp(0.0, 1.0)[..., None]
    wx = (xs - x0i).clamp(0.0, 1.0)[..., None]
    taps = _flat_gather(pack, y0i, x0i).float()
    v00, v01 = taps[..., 0:c], taps[..., c:2 * c]
    v10, v11 = taps[..., 2 * c:3 * c], taps[..., 3 * c:4 * c]
    out = ((v00 * (1 - wx) + v01 * wx) * (1 - wy) +
           (v10 * (1 - wx) + v11 * wx) * wy)
    return torch.where(valid, out, fill)


def affine_warp(img, matrix, fill: float = 0.0):
    """Warp by the inverse affine ``matrix`` ``[B, 2, 3]`` (dest pixel ->
    src pixel)."""
    h, w = img.shape[1], img.shape[2]
    ys, xs = _dest_grid(h, w, device=img.device)
    m = matrix[:, :, :, None, None]
    sx = m[:, 0, 0] * xs + m[:, 0, 1] * ys + m[:, 0, 2]
    sy = m[:, 1, 0] * xs + m[:, 1, 1] * ys + m[:, 1, 2]
    return bilinear_sample(img, sy, sx, fill)


def rotation_matrix(angle_rad, center_y, center_x):
    """``[B, 2, 3]`` inverse map of a rotation by ``angle_rad`` ``[B]``
    about the center (positive = counter-clockwise content, as
    torchvision/Kornia rotate)."""
    c, s = torch.cos(angle_rad), torch.sin(angle_rad)
    tx = center_x - c * center_x + s * center_y
    ty = center_y - s * center_x - c * center_y
    return torch.stack([torch.stack([c, -s, tx], -1),
                        torch.stack([s, c, ty], -1)], -2)


def perspective_warp(img, homography, fill: float = 0.0):
    """Warp by the inverse homographies ``[B, 3, 3]`` (dest -> src)."""
    h, w = img.shape[1], img.shape[2]
    ys, xs = _dest_grid(h, w, device=img.device)
    hm = homography[:, :, :, None, None]
    d = hm[:, 2, 0] * xs + hm[:, 2, 1] * ys + hm[:, 2, 2]
    d = torch.where(d.abs() < 1e-8, torch.full_like(d, 1e-8), d)
    sx = (hm[:, 0, 0] * xs + hm[:, 0, 1] * ys + hm[:, 0, 2]) / d
    sy = (hm[:, 1, 0] * xs + hm[:, 1, 1] * ys + hm[:, 1, 2]) / d
    return bilinear_sample(img, sy, sx, fill)


def displacement_warp(img, dy, dx, fill: float = 0.0):
    """Warp by per-pixel displacements ``[B, H, W]``: src = dest + (dy, dx)."""
    h, w = img.shape[1], img.shape[2]
    ys, xs = _dest_grid(h, w, device=img.device)
    return bilinear_sample(img, ys + dy, xs + dx, fill)


def homography_from_points(src_pts, dst_pts):
    """``[B, 3, 3]`` homographies mapping the 4 ``dst_pts`` to the 4
    ``src_pts`` (each ``[B, 4, 2]`` as (x, y)): the 8 x 8 DLT system,
    solved batched (``solve_ex``: no host sync on the card)."""
    xd, yd = dst_pts[..., 0], dst_pts[..., 1]
    xs_, ys_ = src_pts[..., 0], src_pts[..., 1]
    one, zero = torch.ones_like(xd), torch.zeros_like(xd)
    r1 = torch.stack([xd, yd, one, zero, zero, zero, -xd * xs_, -yd * xs_], -1)
    r2 = torch.stack([zero, zero, zero, xd, yd, one, -xd * ys_, -yd * ys_], -1)
    a = torch.stack([r1, r2], -2).reshape(*xd.shape[:-1], 8, 8)
    rhs = torch.stack([xs_, ys_], -1).reshape(*xd.shape[:-1], 8)
    sol = torch.linalg.solve_ex(a, rhs)[0]
    return torch.cat([sol, torch.ones_like(sol[..., :1])], -1).reshape(
        *xd.shape[:-1], 3, 3)
