"""Deterministic image preprocessing on tensors (counterpart of the JAX
package's ``ops/image.py``).

Images stay NHWC, the JAX package's layout, so the two can be compared
directly.  ``resize_bilinear`` builds JAX's ``jax.image.resize`` weights
(a triangle kernel widened by the downscale factor, columns renormalized)
as one ``[in, out]`` matrix per axis and applies them as two matrix
products; ``F.interpolate(antialias=True)`` builds other weights.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device

# ImageNet statistics (the reference's torchvision Normalize).
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def to_float(x: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [0, 1] (ToTensor without the CHW permute);
    any other dtype -> float32."""
    if x.dtype == torch.uint8:
        return x.to(torch.float32) / 255.0
    return x.to(torch.float32)


def normalize(x: torch.Tensor, mean=IMAGENET_MEAN,
              std=IMAGENET_STD) -> torch.Tensor:
    """Per-channel normalization over the last (channel) axis."""
    mean = torch.as_tensor(mean, dtype=x.dtype, device=x.device)
    std = torch.as_tensor(std, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def denormalize(x: torch.Tensor, mean=IMAGENET_MEAN,
                std=IMAGENET_STD) -> torch.Tensor:
    """Inverse of :func:`normalize`."""
    mean = torch.as_tensor(mean, dtype=x.dtype, device=x.device)
    std = torch.as_tensor(std, dtype=x.dtype, device=x.device)
    return x * std + mean


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """clamp [0, 1] -> round (half to even) -> uint8."""
    return torch.clamp(torch.round(x * 255.0), 0, 255).to(torch.uint8)


def normalize_u8_fused(batch_u8: torch.Tensor,
                       dtype=torch.bfloat16) -> torch.Tensor:
    """uint8 -> normalized ``dtype`` as one affine in f32:
    ``(u8 - 255*mean) * (1 / (255*std))``."""
    dev = batch_u8.device
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=dev) * 255.0
    inv_std = 1.0 / (torch.tensor(IMAGENET_STD, dtype=torch.float32,
                                  device=dev) * 255.0)
    return ((batch_u8.to(torch.float32) - mean) * inv_std).to(dtype)


def _resize_weights(in_size: int, out_size: int, antialias: bool, device):
    """``[in, out]`` f32 weights of ``jax.image.resize``'s linear kernel
    (``compute_weight_mat`` at translation 0), in its f32 arithmetic."""
    f32 = np.float32
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = f32(max(inv_scale, 1.0) if antialias else 1.0)
    sample = ((np.arange(out_size, dtype=f32) + f32(0.5)) * f32(inv_scale)
              - f32(0.0) - f32(0.5))
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]
               ) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    w = np.where(inside[None, :], w, f32(0.0)).astype(f32)
    return torch.from_numpy(w).to(device)


def resize_bilinear(x: torch.Tensor, size: Sequence[int], *,
                    antialias: bool = True) -> torch.Tensor:
    """Bilinear resize of NHWC (or HWC) float images to ``(H, W) =
    size``, with ``jax.image.resize(method="bilinear")``'s weights; an
    axis whose size does not change is left as it is."""
    single = x.dim() == 3
    if single:
        x = x[None]
    if not x.is_floating_point():
        x = x.float()
    h, w = size
    if x.shape[1] != h:
        wy = _resize_weights(x.shape[1], h, antialias, x.device).to(x.dtype)
        x = torch.einsum("nhwc,hH->nHwc", x, wy)
    if x.shape[2] != w:
        wx = _resize_weights(x.shape[2], w, antialias, x.device).to(x.dtype)
        x = torch.einsum("nhwc,wW->nhWc", x, wx)
    return x[0] if single else x


def resize_shorter_side(x: torch.Tensor, target: int, *,
                        antialias: bool = True) -> torch.Tensor:
    """torchvision ``Resize(int)``: the shorter side to ``target``, the
    aspect kept (half away from zero, the host decoders' rounding)."""
    h, w = (x.shape[0], x.shape[1]) if x.dim() == 3 else (x.shape[1],
                                                           x.shape[2])
    if h <= w:
        new_h, new_w = target, max(1, int(w * target / h + 0.5))
    else:
        new_h, new_w = max(1, int(h * target / w + 0.5)), target
    return resize_bilinear(x, (new_h, new_w), antialias=antialias)


def center_crop(x: torch.Tensor, size: int) -> torch.Tensor:
    """Center crop NHWC/HWC to ``(size, size)``."""
    hh, ww = (x.shape[0], x.shape[1]) if x.dim() == 3 else (x.shape[1],
                                                             x.shape[2])
    if size > hh or size > ww:
        raise ValueError(f"center_crop size {size} exceeds input "
                         f"{hh}x{ww}")
    top, left = (hh - size) // 2, (ww - size) // 2
    if x.dim() == 3:
        return x[top:top + size, left:left + size, :]
    return x[:, top:top + size, left:left + size, :]


def preprocess_eval(batch_u8, size: int = 224, out_dtype=torch.float32,
                    denoise: bool = False, *, device=None) -> torch.Tensor:
    """The eval transform: uint8 ``[N, H, W, 3]`` (or float in [0, 1]) ->
    [optional fast-NLM denoise] -> antialiased bilinear resize to
    ``size`` -> ImageNet normalization -> ``out_dtype``.  Runs on the card
    unless ``device="cpu"``; the denoise stage is one launch of the NLM
    kernel there."""
    from .nlm import fast_nlm_denoise

    dev = resolve_device(device)
    x = batch_u8 if isinstance(batch_u8, torch.Tensor) else torch.from_numpy(
        np.asarray(batch_u8))
    x = to_float(x.to(dev))
    if denoise:
        x = fast_nlm_denoise(x)
    x = resize_bilinear(x, (size, size))
    return normalize(x).to(out_dtype)
