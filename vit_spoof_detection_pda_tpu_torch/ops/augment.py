"""Stochastic per-sample augmentation ops (counterpart of the JAX package's
``ops/augment.py``).

The JAX ops are ``op(key, img) -> img`` on one HWC image, batched by
``vmap`` over split keys.  Here every op is batched NHWC and split in
two, so the random part and the arithmetic can be held apart:

- ``draw(generator, batch) -> params``: per-sample parameter tensors with
  a leading ``[B]`` axis, drawn from an explicit ``torch.Generator`` on
  the batch's device (the same distributions as the JAX package's, not
  its bitstreams);
- ``apply(batch, params) -> batch``: a deterministic function of both.

Each op is a :class:`RandomOp` (calling it does both); the JAX package's
function names take ``(generator, batch, ...)``.  Gates select per
sample: a gated-off sample comes back unchanged, bit for bit (the JAX
``lax.cond`` of ``_gate``), and the taken branch casts back to the input
dtype.  Factors are f32 per-sample tensors, so a bf16 image promotes to
f32 inside an op exactly where the JAX ops promote against their f32
scalars.

The geometric tower's scanline passes run on the warp kernel
(``ops/warp.py::warp_pass``, ``csrc/warp_pass.cu``) on the card.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import warp
from .image import IMAGENET_MEAN, IMAGENET_STD

# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------


def _per_sample(v, ndim: int):
    """A ``[B]`` tensor as ``[B, 1, ...]`` of ``ndim`` dims; a Python
    number as it is."""
    if isinstance(v, torch.Tensor) and v.dim() == 1:
        return v.view(-1, *([1] * (ndim - 1)))
    return v


def _uniform(gen, n: int, lo: float, hi: float, device, shape=(),
             dtype=torch.float32):
    u = torch.rand((n, *shape), generator=gen, device=device)
    return (lo + (hi - lo) * u).to(dtype)


def _bernoulli(gen, n: int, p: float, device):
    return torch.rand(n, generator=gen, device=device) < p


def _gate(take, x, y):
    """``y`` (cast back to ``x.dtype``) where ``take``, else ``x``
    unchanged."""
    return torch.where(_per_sample(take, x.dim()), y.to(x.dtype), x)


def _deg2rad(angle):
    return angle * (math.pi / 180.0)


def rgb_to_grayscale(img):
    """ITU-R 601-2 luma (torchvision weights), ``[..., 1]``."""
    w = torch.tensor([0.2989, 0.587, 0.114], dtype=img.dtype,
                     device=img.device)
    return (img * w).sum(-1, keepdim=True)


def _blend(a, b, factor):
    """torchvision blend: ``factor * a + (1 - factor) * b`` in [0, 1]."""
    return torch.clamp(factor * a + (1.0 - factor) * b, 0.0, 1.0)


def _reflect_index(n: int, pad: int, device):
    """Source indices of a reflect-101 pad of ``pad`` on each side of ``n``
    (numpy ``mode="reflect"``, repeated for pads longer than ``n``)."""
    i = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    i = i.remainder(2 * n - 2)
    return torch.where(i >= n, 2 * n - 2 - i, i)


class RandomOp:
    """A per-sample random op: :meth:`draw` then :meth:`apply`."""

    def draw(self, gen: torch.Generator, x: torch.Tensor) -> dict:
        raise NotImplementedError

    def apply(self, x: torch.Tensor, params: dict) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, gen, x):
        return self.apply(x, self.draw(gen, x))


# --------------------------------------------------------------------------
# geometric ops
# --------------------------------------------------------------------------


class RandomHFlip(RandomOp):
    """K.RandomHorizontalFlip / transforms.RandomHorizontalFlip."""

    def __init__(self, p: float = 0.5):
        self.p = p

    def draw(self, gen, x):
        return {"take": _bernoulli(gen, x.shape[0], self.p, x.device)}

    def apply(self, x, params):
        return _gate(params["take"], x, x.flip(2))


class RandomRotation(RandomOp):
    """Rotate by an angle ~ U[-degrees, degrees] about the center,
    bilinear, zero fill (K.RandomRotation)."""

    def __init__(self, degrees: float, p: float = 1.0):
        self.degrees, self.p = degrees, p

    def draw(self, gen, x):
        n, dev = x.shape[0], x.device
        return {"take": _bernoulli(gen, n, self.p, dev),
                "angle": _uniform(gen, n, -self.degrees, self.degrees, dev)}

    def apply(self, x, params):
        h, w = x.shape[1], x.shape[2]
        m = warp.rotation_matrix(_deg2rad(params["angle"]), (h - 1) / 2.0,
                                 (w - 1) / 2.0)
        return _gate(params["take"], x, warp.affine_warp(x, m))


class RandomCrop(RandomOp):
    """Uniform-offset crop to ``(size, size)`` (transforms.RandomCrop)."""

    def __init__(self, size: int):
        self.size = size

    def draw(self, gen, x):
        n, h, w, dev = x.shape[0], x.shape[1], x.shape[2], x.device
        return {"top": torch.randint(0, h - self.size + 1, (n,),
                                     generator=gen, device=dev),
                "left": torch.randint(0, w - self.size + 1, (n,),
                                      generator=gen, device=dev)}

    def apply(self, x, params):
        ar = torch.arange(self.size, device=x.device)
        ys = (params["top"][:, None] + ar)[:, :, None]
        xs = (params["left"][:, None] + ar)[:, None, :]
        bi = torch.arange(x.shape[0], device=x.device)[:, None, None]
        return x[bi, ys, xs]


def _perspective_homography(off, h: int, w: int, distortion_scale: float):
    """Dest -> src homographies ``[B, 3, 3]`` from the corner draws ``off``
    ``[B, 4, 2]`` ~ U[0, 1): dst corners at the frame, src corners moved
    inward by ``off * distortion_scale * half`` (Kornia's geometry)."""
    dev = off.device
    dxm = distortion_scale * (w - 1) / 2.0
    dym = distortion_scale * (h - 1) / 2.0
    dst = torch.tensor([[0.0, 0.0], [w - 1.0, 0.0], [w - 1.0, h - 1.0],
                        [0.0, h - 1.0]], device=dev)
    inward = torch.tensor([[1.0, 1.0], [-1.0, 1.0], [-1.0, -1.0],
                           [1.0, -1.0]], device=dev)
    src = dst + off * torch.tensor([dxm, dym], device=dev) * inward
    return warp.homography_from_points(src, dst.expand_as(src))


def _elastic_fields(noise_y, noise_x, *, alpha, sigma, kernel_size,
                    kern_dtype):
    """Smoothed displacement fields ``(dy, dx)`` ``[B, H, W]`` from the
    noise draws ``[B, H, W]`` ~ U[-1, 1] (in the noise's dtype)."""
    h, w = noise_y.shape[1], noise_y.shape[2]
    kern = _gaussian_kernel1d(kernel_size, sigma, kern_dtype,
                              device=noise_y.device)
    dx = _separable_blur2d(noise_x[..., None], kern)[..., 0] * alpha * (w / 2.0)
    dy = _separable_blur2d(noise_y[..., None], kern)[..., 0] * alpha * (h / 2.0)
    return dy, dx


class RandomPerspective(RandomOp):
    """Move the 4 corners inward by U[0, d * half] and warp (bilinear)."""

    def __init__(self, distortion_scale: float, p: float = 0.5):
        self.distortion_scale, self.p = distortion_scale, p

    def draw(self, gen, x):
        n, dev = x.shape[0], x.device
        return {"take": _bernoulli(gen, n, self.p, dev),
                "off": _uniform(gen, n, 0.0, 1.0, dev, (4, 2))}

    def apply(self, x, params):
        hm = _perspective_homography(params["off"], x.shape[1], x.shape[2],
                                     self.distortion_scale)
        return _gate(params["take"], x, warp.perspective_warp(x, hm))


class ElasticTransform(RandomOp):
    """Smoothed random displacement field (K.RandomElasticTransform
    defaults: kernel 63, sigma 32, alpha 1, in half-image units)."""

    def __init__(self, alpha: float = 1.0, sigma: float = 32.0,
                 kernel_size: int = 63, p: float = 1.0):
        self.alpha, self.sigma, self.kernel_size, self.p = (
            alpha, sigma, kernel_size, p)

    def draw(self, gen, x):
        n, h, w, dev = x.shape[0], x.shape[1], x.shape[2], x.device
        return {"take": _bernoulli(gen, n, self.p, dev),
                "noise_y": _uniform(gen, n, -1.0, 1.0, dev, (h, w)),
                "noise_x": _uniform(gen, n, -1.0, 1.0, dev, (h, w))}

    def apply(self, x, params):
        dy, dx = _elastic_fields(params["noise_y"], params["noise_x"],
                                 alpha=self.alpha, sigma=self.sigma,
                                 kernel_size=self.kernel_size,
                                 kern_dtype=x.dtype)
        return _gate(params["take"], x, warp.displacement_warp(x, dy, dx))


# --------------------------------------------------------------------------
# photometric ops
# --------------------------------------------------------------------------


def adjust_brightness(img, factor):
    return torch.clamp(img * _per_sample(factor, img.dim()), 0.0, 1.0)


def adjust_contrast(img, factor):
    mean = rgb_to_grayscale(img).mean(dim=(1, 2, 3), keepdim=True)
    return _blend(img, mean, _per_sample(factor, img.dim()))


def adjust_saturation(img, factor):
    return _blend(img, rgb_to_grayscale(img), _per_sample(factor, img.dim()))


# Normalized-domain jitter: the reference's tiers jitter ImageNet-
# normalized tensors; each op below is the exact [0, 1]-space image of
# the unit op applied in normalized space (channel-mean pivots, no clip).


def _stats(img):
    def t(v):
        return torch.tensor(v, dtype=img.dtype, device=img.device)
    return t([0.2989, 0.587, 0.114]), t(IMAGENET_MEAN), t(IMAGENET_STD)


def _grayscale_normdomain(img):
    """gray(normalize(img)) as ``[..., 1]`` (in normalized units)."""
    w, m, s = _stats(img)
    return ((img - m) / s * w).sum(-1, keepdim=True)


def adjust_brightness_normdomain(img, factor):
    _, m, _ = _stats(img)
    f = _per_sample(factor, img.dim())
    return f * img + (1.0 - f) * m


def adjust_contrast_normdomain(img, factor):
    _, m, s = _stats(img)
    f = _per_sample(factor, img.dim())
    g = _grayscale_normdomain(img).mean(dim=(1, 2, 3), keepdim=True)
    return f * img + (1.0 - f) * (m + s * g)


def adjust_saturation_normdomain(img, factor):
    _, m, s = _stats(img)
    f = _per_sample(factor, img.dim())
    return f * img + (1.0 - f) * (m + s * _grayscale_normdomain(img))


def adjust_hue(img, delta):
    """Shift hue by ``delta`` (a fraction of a turn, per sample) through
    RGB -> HSV -> RGB."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = img.amax(-1)
    minc = img.amin(-1)
    v = maxc
    c = maxc - minc
    s = torch.where(maxc > 0, c / torch.clamp_min(maxc, 1e-8), 0.0)
    safe_c = torch.clamp_min(c, 1e-8)
    rc = (maxc - r) / safe_c
    gc = (maxc - g) / safe_c
    bc = (maxc - b) / safe_c
    hue = torch.where(r == maxc, bc - gc,
                      torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    hue = torch.remainder(hue / 6.0, 1.0)
    hue = torch.where(c > 0, hue, 0.0)
    hue = torch.remainder(hue + _per_sample(delta, hue.dim()), 1.0)

    i = torch.floor(hue * 6.0)
    f = hue * 6.0 - i
    pp = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.long().remainder(6)[..., None]
    dt = torch.promote_types(v.dtype, q.dtype)
    cands = [x.to(dt) for x in (v, q, pp, t)]

    def select(order):
        return torch.gather(torch.stack([cands[k] for k in order], -1), -1,
                            i)[..., 0]

    return torch.stack([select((0, 1, 2, 2, 3, 0)),
                        select((3, 0, 0, 1, 2, 2)),
                        select((2, 2, 3, 0, 0, 1))], -1)


class ColorJitter(RandomOp):
    """ColorJitter: per-sample factors b, c, s ~ U[max(0, 1 - x), 1 + x],
    hue ~ U[-h, h].  ``order="random"``: the four ops in a per-sample
    random order (torchvision); ``"fixed"``: brightness -> contrast ->
    saturation -> hue (Kornia ``ColorJitter``, the tiers).
    ``domain="normalized"``: the normalized-space brightness / contrast /
    saturation of the reference tiers (hue stays unit)."""

    def __init__(self, brightness: float = 0.0, contrast: float = 0.0,
                 saturation: float = 0.0, hue: float = 0.0, p: float = 1.0,
                 order: str = "random", domain: str = "unit"):
        if domain not in ("unit", "normalized"):
            raise ValueError(f"unknown jitter domain {domain!r}")
        if order not in ("random", "fixed"):
            raise ValueError(f"unknown jitter order {order!r}")
        self.ranges = [(max(0.0, 1 - brightness), 1 + brightness),
                       (max(0.0, 1 - contrast), 1 + contrast),
                       (max(0.0, 1 - saturation), 1 + saturation),
                       (-hue, hue)]
        self.p, self.order, self.domain = p, order, domain

    def draw(self, gen, x):
        n, dev = x.shape[0], x.device
        params = {"take": _bernoulli(gen, n, self.p, dev)}
        for name, (lo, hi) in zip("bcsh", self.ranges):
            params[name] = _uniform(gen, n, lo, hi, dev)
        if self.order == "random":
            params["perm"] = torch.rand((n, 4), generator=gen,
                                        device=dev).argsort(-1)
        return params

    def apply(self, x, params):
        adj = ((adjust_brightness, adjust_contrast, adjust_saturation)
               if self.domain == "unit" else
               (adjust_brightness_normdomain, adjust_contrast_normdomain,
                adjust_saturation_normdomain))
        branches = [
            lambda im: adj[0](im, params["b"]).to(im.dtype),
            lambda im: adj[1](im, params["c"]).to(im.dtype),
            lambda im: adj[2](im, params["s"]).to(im.dtype),
            lambda im: adjust_hue(im, params["h"]).to(im.dtype),
        ]
        im = x
        if self.order == "fixed":
            for fn in branches:
                im = fn(im)
        else:
            rows = torch.arange(x.shape[0], device=x.device)
            for i in range(4):
                outs = torch.stack([fn(im) for fn in branches])
                im = outs[params["perm"][:, i], rows]
        return _gate(params["take"], x, im)


def _gaussian_kernel1d(size: int, sigma, dtype=torch.float32, device=None):
    """Normalized Gaussian taps ``[size]`` (``sigma`` a number) or
    ``[B, size]`` (``sigma`` a ``[B]`` tensor), computed in f32."""
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    if isinstance(sigma, torch.Tensor):
        sigma = sigma.float()[:, None]
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum(-1, keepdim=True)).to(dtype)


def _separable_blur2d(img, kernel1d):
    """Depthwise separable blur of ``[B, H, W, C]`` with reflect-101
    padding: a vertical then a horizontal 1-D correlation (the kernel is
    symmetric).  ``kernel1d`` ``[K]`` for every sample or ``[B, K]``."""
    b, h, w, c = img.shape
    ksz = kernel1d.shape[-1]
    pad = ksz // 2
    kern = kernel1d.to(img.dtype).expand(b, ksz).repeat_interleave(c, 0)
    x = img.permute(0, 3, 1, 2)
    x = x.index_select(2, _reflect_index(h, pad, img.device))
    x = x.index_select(3, _reflect_index(w, pad, img.device))
    x = x.reshape(1, b * c, h + 2 * pad, w + 2 * pad)
    x = F.conv2d(x, kern.view(b * c, 1, ksz, 1), groups=b * c)
    x = F.conv2d(x, kern.view(b * c, 1, 1, ksz), groups=b * c)
    return x.view(b, c, h, w).permute(0, 2, 3, 1)


class GaussianBlur(RandomOp):
    """Separable Gaussian blur with sigma ~ U[lo, hi] per sample
    (K.RandomGaussianBlur), as a convolution (the JAX package's
    ``method="matmul"`` is the TPU's banded-matmul form of the same
    function and is not ported)."""

    def __init__(self, kernel_size: int, sigma_range: Tuple[float, float],
                 p: float = 1.0):
        self.kernel_size, self.sigma_range, self.p = kernel_size, sigma_range, p

    def draw(self, gen, x):
        n, dev = x.shape[0], x.device
        return {"take": _bernoulli(gen, n, self.p, dev),
                "sigma": _uniform(gen, n, *self.sigma_range, dev)}

    def apply(self, x, params):
        kern = _gaussian_kernel1d(self.kernel_size, params["sigma"], x.dtype,
                                  device=x.device)
        return _gate(params["take"], x, _separable_blur2d(x, kern))


class GaussianNoise(RandomOp):
    """Additive Gaussian noise, no clamp (K.RandomGaussianNoise); ``std``
    may be a per-channel vector."""

    def __init__(self, std=0.05, mean: float = 0.0, p: float = 1.0):
        self.std, self.mean, self.p = std, mean, p

    def draw(self, gen, x):
        n, dev = x.shape[0], x.device
        return {"take": _bernoulli(gen, n, self.p, dev),
                "noise": torch.randn(x.shape, generator=gen,
                                     device=dev).to(x.dtype)}

    def apply(self, x, params):
        s = torch.tensor(self.std, dtype=x.dtype, device=x.device)
        return _gate(params["take"], x,
                     x + self.mean + s * params["noise"].to(x.dtype))


class RandomSharpness(RandomOp):
    """Blend with the 3 x 3 smoothing kernel [[1,1,1],[1,5,1],[1,1,1]]/13,
    factor ~ U[0, sharpness], the 1-pixel border kept (K.RandomSharpness)."""

    def __init__(self, sharpness: float = 2.0, p: float = 1.0):
        self.sharpness, self.p = sharpness, p

    def draw(self, gen, x):
        n, dev = x.shape[0], x.device
        return {"take": _bernoulli(gen, n, self.p, dev),
                "factor": _uniform(gen, n, 0.0, self.sharpness, dev)}

    def apply(self, x, params):
        b, h, w, c = x.shape
        kern = torch.tensor([[1.0, 1.0, 1.0], [1.0, 5.0, 1.0],
                             [1.0, 1.0, 1.0]], dtype=x.dtype,
                            device=x.device) / 13.0
        xp = x.permute(0, 3, 1, 2)
        for d, n in ((2, h), (3, w)):
            xp = xp.index_select(d, torch.arange(-1, n + 1, device=x.device
                                                 ).clamp(0, n - 1))
        smoothed = F.conv2d(xp, kern.expand(c, 1, 3, 3), groups=c)
        out = _blend(x, smoothed.permute(0, 2, 3, 1),
                     _per_sample(params["factor"], 4))
        ys = torch.arange(h, device=x.device)[:, None, None]
        xs = torch.arange(w, device=x.device)[None, :, None]
        border = (ys == 0) | (ys == h - 1) | (xs == 0) | (xs == w - 1)
        return _gate(params["take"], x, torch.where(border, x, out))


class RandomErasing(RandomOp):
    """Erase one rectangle (transforms.RandomErasing), single draw: area
    and aspect sampled once, the rectangle clamped to fit."""

    def __init__(self, p: float = 0.25,
                 scale: Tuple[float, float] = (0.02, 0.33),
                 ratio: Tuple[float, float] = (0.3, 3.3), value: float = 0.0):
        self.p, self.scale, self.ratio, self.value = p, scale, ratio, value

    def draw(self, gen, x):
        n, h, w, dev = x.shape[0], x.shape[1], x.shape[2], x.device
        return {"take": _bernoulli(gen, n, self.p, dev),
                "area": _uniform(gen, n, *self.scale, dev),
                "log_ratio": _uniform(gen, n, math.log(self.ratio[0]),
                                      math.log(self.ratio[1]), dev),
                "top": torch.randint(0, h, (n,), generator=gen, device=dev),
                "left": torch.randint(0, w, (n,), generator=gen, device=dev)}

    def apply(self, x, params):
        h, w = x.shape[1], x.shape[2]
        area = h * w * params["area"]
        r = torch.exp(params["log_ratio"])
        eh = torch.clamp(torch.round(torch.sqrt(area * r)), 1, h).long()
        ew = torch.clamp(torch.round(torch.sqrt(area / r)), 1, w).long()
        top = torch.minimum(params["top"], h - eh)
        left = torch.minimum(params["left"], w - ew)
        ys = torch.arange(h, device=x.device)[None, :, None, None]
        xs = torch.arange(w, device=x.device)[None, None, :, None]
        top, left, eh, ew = (_per_sample(v, 4) for v in (top, left, eh, ew))
        mask = (ys >= top) & (ys < top + eh) & (xs >= left) & (xs < left + ew)
        return _gate(params["take"], x, torch.where(mask, self.value, x))


# --------------------------------------------------------------------------
# composed geometric warp
# --------------------------------------------------------------------------


def _perspective_kmax(scale: float, size: int) -> int:
    """Static pass bound for a distortion-``scale`` homography on a
    ``size``^2 image: the corner displacement with 35% + 2 px headroom."""
    return int(math.ceil(1.35 * scale * (size - 1) / 2.0)) + 2


def _elastic_kmax(alpha: float, sigma: float, ksize: int,
                  size: int) -> int:
    """Static pass bound for the elastic field: 6.5 std + 2 px."""
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    std = alpha * (size / 2.0) * math.sqrt(1.0 / 3.0) * float((k * k).sum())
    return max(4, int(math.ceil(6.5 * std)) + 2)


class ComposedGeometric(RandomOp):
    """Flip + rotation + perspective + elastic with one set of draws.

    ``sampler="tower"``: flip, then the 3-shear rotation, the exact
    2-pass perspective and the 2-pass elastic warp, every pass one launch
    of the warp kernel; every configured pass runs whatever the gates drew
    (a gated-off part is an identity pass).  ``"gather"``: the composed
    map sampled once with bf16 taps (the numerical oracle).  With neither
    perspective nor elastic only flip and rotation run (the affine path of
    the train-time chain and the light tier).  ``fill``: the out-of-frame
    colour (IMAGENET_MEAN in the tiers), exact by linearity:
    ``fill + warp(x - fill)``.

    Params: ``flip`` [B] bool (if ``hflip_p > 0``); ``angle`` [B] and
    ``rot_gate`` [B] bool; ``off`` [B, 4, 2] and ``persp_gate``;
    ``noise_y`` / ``noise_x`` [B, H, W] in the image dtype and
    ``elastic_gate``."""

    def __init__(self, *, hflip_p: float = 0.0, rotation=None,
                 perspective=None, elastic=None, fill=0.0,
                 sampler: str = "tower"):
        if (perspective is not None or elastic is not None) and sampler not in (
                "tower", "gather"):
            raise ValueError(f"unknown sampler {sampler!r} (tower | gather)")
        self.hflip_p, self.rotation = hflip_p, rotation
        self.perspective, self.elastic = perspective, elastic
        self.fill, self.sampler = fill, sampler

    def draw(self, gen, x):
        n, h, w, dev = x.shape[0], x.shape[1], x.shape[2], x.device
        params = {}
        if self.hflip_p > 0.0:
            params["flip"] = _bernoulli(gen, n, self.hflip_p, dev)
        if self.rotation is not None:
            degrees, p = self.rotation
            params["angle"] = _uniform(gen, n, -degrees, degrees, dev)
            params["rot_gate"] = _bernoulli(gen, n, p, dev)
        if self.perspective is not None:
            params["off"] = _uniform(gen, n, 0.0, 1.0, dev, (4, 2))
            params["persp_gate"] = _bernoulli(gen, n, self.perspective[1], dev)
        if self.elastic is not None:
            params["noise_y"] = _uniform(gen, n, -1.0, 1.0, dev, (h, w),
                                         x.dtype)
            params["noise_x"] = _uniform(gen, n, -1.0, 1.0, dev, (h, w),
                                         x.dtype)
            params["elastic_gate"] = _bernoulli(gen, n, self.elastic[3], dev)
        return params

    def apply(self, x, params):
        if np.any(np.asarray(self.fill) != 0):
            f = torch.tensor(self.fill, dtype=x.dtype, device=x.device)
            return f + self._warp(x - f, params)
        return self._warp(x, params)

    def _warp(self, x, params):
        h, w = x.shape[1], x.shape[2]
        flip = params.get("flip")
        angle = None
        if self.rotation is not None:
            angle = params["angle"] * params["rot_gate"].float()
        if self.perspective is None and self.elastic is None:
            out = x
            if flip is not None:
                out = torch.where(_per_sample(flip, 4), out.flip(2), out)
            if angle is not None:
                out = warp.rotate_3shear(out, _deg2rad(angle), self.rotation[0])
            return out

        fields = None
        if self.elastic is not None:
            alpha, sigma, ksize, _ = self.elastic
            dy, dx = _elastic_fields(params["noise_y"], params["noise_x"],
                                     alpha=alpha, sigma=sigma,
                                     kernel_size=ksize, kern_dtype=x.dtype)
            gate = _per_sample(params["elastic_gate"].to(x.dtype), 3)
            fields = (dy * gate, dx * gate)
        hm = None
        if self.perspective is not None:
            scale = self.perspective[0]
            hm = _perspective_homography(params["off"], h, w, scale)
            eye = torch.eye(3, dtype=hm.dtype, device=hm.device)
            hm = torch.where(params["persp_gate"][:, None, None], hm, eye)

        if self.sampler == "tower":
            out = x
            if flip is not None:
                out = torch.where(_per_sample(flip, 4), out.flip(2), out)
            if angle is not None:
                out = warp.rotate_3shear(out, _deg2rad(angle), self.rotation[0])
            if hm is not None:
                out = warp.perspective_warp_2pass(
                    out, hm, kmax=_perspective_kmax(scale, max(h, w)))
            if fields is not None:
                out = warp.displacement_warp_2pass(
                    out, fields[0].float(), fields[1].float(),
                    kmax=_elastic_kmax(alpha, sigma, ksize, max(h, w)))
            return out

        ys, xs = warp._dest_grid(h, w, device=x.device)
        ys, xs = ys[None], xs[None]
        if fields is not None:
            ys, xs = ys + fields[0], xs + fields[1]
        if hm is not None:
            m = hm[:, :, :, None, None]
            den = m[:, 2, 0] * xs + m[:, 2, 1] * ys + m[:, 2, 2]
            den = torch.where(den.abs() < 1e-8, torch.full_like(den, 1e-8), den)
            xs, ys = ((m[:, 0, 0] * xs + m[:, 0, 1] * ys + m[:, 0, 2]) / den,
                      (m[:, 1, 0] * xs + m[:, 1, 1] * ys + m[:, 1, 2]) / den)
        if angle is not None:
            r = warp.rotation_matrix(_deg2rad(angle), (h - 1) / 2.0,
                                     (w - 1) / 2.0)[:, :, :, None, None]
            xs, ys = (r[:, 0, 0] * xs + r[:, 0, 1] * ys + r[:, 0, 2],
                      r[:, 1, 0] * xs + r[:, 1, 1] * ys + r[:, 1, 2])
        if flip is not None:
            xs = torch.where(_per_sample(flip, 3), (w - 1.0) - xs, xs)
        return warp.bilinear_sample_packed(x, ys.expand(x.shape[0], h, w),
                                           xs.expand(x.shape[0], h, w),
                                           tap_dtype=torch.bfloat16)


# --------------------------------------------------------------------------
# the JAX package's function names: (generator, batch, ...) -> batch
# --------------------------------------------------------------------------


def random_hflip(gen, img, p: float = 0.5):
    return RandomHFlip(p)(gen, img)


def random_rotation(gen, img, degrees: float, p: float = 1.0):
    return RandomRotation(degrees, p)(gen, img)


def random_crop(gen, img, size: int):
    return RandomCrop(size)(gen, img)


def random_perspective(gen, img, distortion_scale: float, p: float = 0.5):
    return RandomPerspective(distortion_scale, p)(gen, img)


def elastic_transform(gen, img, alpha: float = 1.0, sigma: float = 32.0,
                      kernel_size: int = 63, p: float = 1.0):
    return ElasticTransform(alpha, sigma, kernel_size, p)(gen, img)


def color_jitter(gen, img, brightness: float = 0.0, contrast: float = 0.0,
                 saturation: float = 0.0, hue: float = 0.0, p: float = 1.0,
                 order: str = "random", domain: str = "unit"):
    return ColorJitter(brightness, contrast, saturation, hue, p, order,
                       domain)(gen, img)


def gaussian_blur(gen, img, kernel_size: int,
                  sigma_range: Tuple[float, float], p: float = 1.0):
    return GaussianBlur(kernel_size, sigma_range, p)(gen, img)


def gaussian_noise(gen, img, std=0.05, mean: float = 0.0, p: float = 1.0):
    return GaussianNoise(std, mean, p)(gen, img)


def random_sharpness(gen, img, sharpness: float = 2.0, p: float = 1.0):
    return RandomSharpness(sharpness, p)(gen, img)


def random_erasing(gen, img, p: float = 0.25,
                   scale: Tuple[float, float] = (0.02, 0.33),
                   ratio: Tuple[float, float] = (0.3, 3.3),
                   value: float = 0.0):
    return RandomErasing(p, scale, ratio, value)(gen, img)


def composed_geometric(gen, img, *, hflip_p: float = 0.0, rotation=None,
                       perspective=None, elastic=None, fill=0.0,
                       sampler: str = "tower"):
    return ComposedGeometric(hflip_p=hflip_p, rotation=rotation,
                             perspective=perspective, elastic=elastic,
                             fill=fill, sampler=sampler)(gen, img)


def apply_chain(gen: torch.Generator, batch: torch.Tensor,
                chain: Sequence) -> torch.Tensor:
    """Apply each op of ``chain`` (``op(generator, batch) -> batch``) in
    order; every op draws its own per-sample parameters from ``gen``."""
    for op in chain:
        batch = op(gen, batch)
    return batch
