"""Attention-rollout saliency maps for failed-case explainability (the
port's copy of the JAX package's ``analysis/attention_maps.py``).

Attention rollout (Abnar & Zuidema, "Quantifying Attention Flow in
Transformers", 2020) over the anti-spoof ViT: each layer's [T, T]
attention averaged over heads, mixed with the residual identity,
row-normalized and multiplied through the stack; the CLS row restricted to
the patch tokens is the per-patch relevance.

The capture path is the module's own (``models/vit.py::Attention`` with
``capture=True``: the dense einsum, keeping the f32 softmax in
``attn_probs``).  :func:`capture_attention_probs` and
:func:`cls_patch_relevance_device` turn capture on in the blocks of the
module they are given for the length of the call and back off after, so
no second module is built; the serving and training paths never capture.
:func:`cls_patch_relevance_device` runs the rollout on the module's device
in f32 (TF32 off) and brings back only the ``[B, N]`` CLS row.

CLI: ``analyze --attention-overlays <image dir>`` (needs
``eval.checkpoint_path``); library: :func:`generate_attention_overlays`
(matplotlib and PIL, imported when called).
"""

from __future__ import annotations

import contextlib
import logging
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from ..device import exact_f32_matmul

log = logging.getLogger(__name__)


def attention_rollout(probs_per_layer: Sequence[np.ndarray],
                      residual: float = 0.5) -> np.ndarray:
    """Rollout relevance from per-layer attention softmaxes (float64 on the
    host).  ``probs_per_layer``: ``depth`` arrays of [B, H, T, T] (query
    axis before key axis).  Each layer's head mean is mixed with the
    identity (``residual`` its weight, the paper's (A + I) / 2),
    row-normalized, and the stack multiplied first-layer-innermost.
    Returns [B, T, T]; the caller usually takes ``[:, 0, 1:]``."""
    if not probs_per_layer:
        raise ValueError("need at least one layer of attention probs")
    rollout = None
    for probs in probs_per_layer:
        a = np.asarray(probs, np.float64).mean(axis=1)      # [B, T, T]
        t = a.shape[-1]
        a = (1.0 - residual) * a + residual * np.eye(t)
        a = a / a.sum(axis=-1, keepdims=True)
        rollout = a if rollout is None else a @ rollout
    return rollout


def _grid_normalized(cls: np.ndarray, grid_hw) -> np.ndarray:
    """``[B, N]`` CLS relevance -> ``[B, gh, gw]``, max 1 per image."""
    n = cls.shape[-1]
    if grid_hw is None:
        g = int(round(n ** 0.5))
        if g * g != n:
            raise ValueError(f"{n} patch tokens is not square; pass "
                             f"grid_hw")
        grid_hw = (g, g)
    cls = cls.reshape(cls.shape[0], *grid_hw)
    peak = cls.max(axis=(1, 2), keepdims=True)
    return cls / np.where(peak > 0, peak, 1.0)


def cls_patch_relevance(probs_per_layer, *, grid_hw=None,
                        residual: float = 0.5) -> np.ndarray:
    """[B, gh, gw] normalized (max 1 per image) CLS -> patch relevance."""
    rollout = attention_rollout(probs_per_layer, residual=residual)
    return _grid_normalized(rollout[:, 0, 1:], grid_hw)


def _backbone(module):
    """The ``ViT`` whose blocks capture; raises ``ValueError`` off the ViT
    family that carries the flag in the JAX package (``ViT``,
    ``ViTAntiSpoof``)."""
    from ..models.vit import ViT, ViTAntiSpoof

    if isinstance(module, ViTAntiSpoof):
        return module.vit
    if isinstance(module, ViT):
        return module
    raise ValueError(
        f"{type(module).__name__} has no capture_attention flag — "
        f"attention rollout is only wired for the ViT family")


@contextlib.contextmanager
def _capturing(module):
    """Capture on in every block of ``module`` (and eval mode) for the
    block; the blocks' ``Attention`` modules are yielded in layer order."""
    attns = [blk.attn for blk in _backbone(module).blocks]
    saved = [a.capture for a in attns]
    training = module.training
    module.eval()
    for a in attns:
        a.capture = True
    try:
        yield attns
    finally:
        for a, c in zip(attns, saved):
            a.capture, a.attn_probs = c, None
        module.train(training)


def _captured_forward(module, images):
    """The module's forward on ``images`` with capture on: each layer's
    f32 softmax ``[B, H, T, T]`` as a tensor on the module's device."""
    dev = next(module.parameters()).device
    x = torch.as_tensor(images).to(dev, torch.float32)
    with _capturing(module) as attns, torch.inference_mode(), \
            exact_f32_matmul():
        module(x)
        return [a.attn_probs for a in attns]


def capture_attention_probs(module, images) -> list:
    """The per-layer [B, H, T, T] attention softmaxes (f32 numpy, layer
    order) of ``module`` on a batch of normalized float images
    (``ops/image.py::preprocess_eval``'s output).  The module holds its
    weights; capture is on for this call only."""
    return [p.cpu().numpy() for p in _captured_forward(module, images)]


def cls_patch_relevance_device(module, images, *, residual: float = 0.5,
                               grid_hw=None) -> np.ndarray:
    """[B, gh, gw] CLS -> patch rollout relevance with the captured forward
    and the rollout on the module's device: f32, TF32 off, only the
    ``[B, N]`` CLS row comes to the host.  The CLS row of the rollout is
    ``e0 A_L ... A_1``, so the chain runs from the last layer down as
    vector-matrix products; within about 1e-6 of the float64 host rollout
    (row-stochastic factors keep the product conditioned)."""
    probs = _captured_forward(module, images)
    with exact_f32_matmul():
        row = None
        for p in reversed(probs):
            a = p.mean(dim=1)                                # [B, T, T]
            eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
            a = (1.0 - residual) * a + residual * eye
            a = a / a.sum(dim=-1, keepdim=True)
            row = a[:, 0] if row is None else torch.bmm(
                row.unsqueeze(1), a).squeeze(1)
        cls = row[:, 1:].cpu().numpy().astype(np.float64)      # [B, N]
    del probs
    return _grid_normalized(cls, grid_hw)


def generate_attention_overlays(module, image_paths, out_dir: str, *,
                                img_size: int = 224, batch_size: int = 16,
                                scores=None) -> dict:
    """Write ``<out_dir>/<stem>_attn.png`` heat overlays for each image:
    decoded as the eval pipeline decodes (square ``img_size``), the
    rollout upsampled bilinearly onto the image, image | overlay side by
    side.  ``scores``: optional P(live) per image for the title.  The tail
    chunk is padded to ``batch_size`` with its last image.  Returns
    ``{"out_dir", "files"}``.  Needs matplotlib and PIL."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..data.loader import decode_image
    from ..ops.image import preprocess_eval

    dev = next(module.parameters()).device
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    paths = [Path(p) for p in image_paths]
    files = []
    for start in range(0, len(paths), batch_size):
        chunk = paths[start:start + batch_size]
        frames = np.stack([decode_image(str(p), img_size) for p in chunk])
        padded = frames if len(chunk) == batch_size else np.concatenate(
            [frames, np.repeat(frames[-1:], batch_size - len(chunk), 0)])
        batch = preprocess_eval(padded, size=img_size, device=dev)
        rel = cls_patch_relevance_device(module, batch)[:len(chunk)]
        for j, p in enumerate(chunk):
            heat = _upsample_bilinear(rel[j], img_size, img_size)
            fig, axes = plt.subplots(1, 2, figsize=(6.4, 3.4))
            axes[0].imshow(frames[j])
            axes[0].set_title(p.name, fontsize=8)
            axes[1].imshow(frames[j])
            axes[1].imshow(heat, cmap="jet", alpha=0.45,
                           interpolation="nearest")
            title = "attention rollout"
            if scores is not None:
                title += f"  P(live)={float(scores[start + j]):.3f}"
            axes[1].set_title(title, fontsize=8)
            for ax in axes:
                ax.axis("off")
            fname = out / f"{p.stem}_attn.png"
            fig.savefig(fname, dpi=120, bbox_inches="tight")
            plt.close(fig)
            files.append(str(fname))
    log.info("wrote %d attention overlays under %s", len(files), out)
    return {"out_dir": str(out), "files": files}


def _upsample_bilinear(grid: np.ndarray, h: int, w: int) -> np.ndarray:
    """[gh, gw] -> [h, w] bilinear (align_corners=False, like the eval
    resize)."""
    gh, gw = grid.shape
    ys = (np.arange(h) + 0.5) * gh / h - 0.5
    xs = (np.arange(w) + 0.5) * gw / w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, gh - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, gw - 1)
    y1 = np.clip(y0 + 1, 0, gh - 1)
    x1 = np.clip(x0 + 1, 0, gw - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :]
    top = grid[y0[:, None], x0[None, :]] * (1 - wx) + \
        grid[y0[:, None], x1[None, :]] * wx
    bot = grid[y1[:, None], x0[None, :]] * (1 - wx) + \
        grid[y1[:, None], x1[None, :]] * wx
    return top * (1 - wy) + bot * wy
