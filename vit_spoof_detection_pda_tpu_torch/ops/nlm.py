"""Fast non-local-means denoise (counterpart of the JAX package's
``ops/nlm.py``): the optional denoise stage of ``ops.image.preprocess_eval``.

For every offset of a ``(2r + 1)^2`` search window the patch distance
between a pixel and its shifted counterpart is a box sum of the
pointwise squared difference; weights ``w = exp(-max(d2 - 2 sigma^2, 0) /
h^2)`` (Buades et al., with the box-filter trick).  Borders clamp: the
shifted source and the patch window both read edge-clamped pixels.

On a CUDA tensor :func:`fast_nlm_denoise` launches the hand-written kernel
``csrc/nlm.cu`` (it replaces the TPU kernel ``ops/nlm_pallas.py::
_nlm_kernel``) for any H x W; the TPU's VMEM gate and one-hot shift
matmuls were Mosaic workarounds and are not ported.  On a CPU tensor it
runs :func:`nlm_denoise_plain`, which follows the kernel's arithmetic
order: direct patch sums (the JAX XLA form's ``_box_filter`` takes
differences of cumulative sums, which round differently at 224^2).
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


def _edge_pad(x, radius: int, dims=(1, 2)):
    """Edge-pad ``x`` by ``radius`` along ``dims`` (index clamps)."""
    for d in dims:
        n = x.shape[d]
        idx = torch.arange(-radius, n + radius, device=x.device).clamp(0, n - 1)
        x = x.index_select(d, idx)
    return x


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
    CUDA tensor (C <= 4), :func:`nlm_denoise_plain` on a CPU tensor."""
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
