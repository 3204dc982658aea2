"""Random weights of a configuration, made on the device from the seed in
one call, in the published (timm / reference script) key layout, float32
as both the program's modules and the reference hold them.

Scales: the encoder's matrices and biases N(0, 0.02) (timm's and HF's
ViT init), LayerNorm scales 1 + N(0, 0.1) and biases N(0, 0.05), so that
they are not all alike; the heads as a fine-tuning run makes them fresh:
the MLP head's Linears at torch's default scale (a uniform of bound
in^-1/2, standard deviation (3 in)^-1/2), the linear classifier at HF's
N(0, 0.02).
"""

from __future__ import annotations

import torch

from .generate import generator


def _ln(key, d):
    return [(key + ".weight", (d,), 0.1, 1.0), (key + ".bias", (d,), 0.05, 0.0)]


def _dense(key, i, o, std, bias_std=0.02):
    return [(key + ".weight", (o, i), std, 0.0), (key + ".bias", (o,), bias_std, 0.0)]


def spec(cfg) -> list:
    """``[(key, shape, std, mean)]`` of every leaf, in a fixed order."""
    d, f, c = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_channels"]
    p, n = cfg["patch_size"], (cfg["image_size"] // cfg["patch_size"]) ** 2
    out = [("vit.patch_embed.proj.weight", (d, c, p, p), 0.02, 0.0),
           ("vit.patch_embed.proj.bias", (d,), 0.02, 0.0),
           ("vit.cls_token", (1, 1, d), 0.02, 0.0),
           ("vit.pos_embed", (1, n + 1, d), 0.02, 0.0)]
    for i in range(cfg["num_hidden_layers"]):
        b = f"vit.blocks.{i}."
        out += (_ln(b + "norm1", d) + _dense(b + "attn.qkv", d, 3 * d, 0.02)
                + _dense(b + "attn.proj", d, d, 0.02) + _ln(b + "norm2", d)
                + _dense(b + "mlp.fc1", d, f, 0.02)
                + _dense(b + "mlp.fc2", f, d, 0.02))
    out += _ln("vit.norm", d)
    if cfg["head"] == "linear":
        out += _dense("classifier", d, cfg["num_labels"], 0.02)
    else:
        h = cfg["head_hidden_size"]
        s1, s2 = (3 * d) ** -0.5, (3 * h) ** -0.5
        out += (_ln("classifier.0", d) + _dense("classifier.2", d, h, s1, s1)
                + _dense("classifier.5", h, cfg["num_labels"], s2, s2))
    return out


def make(cfg, seed: int, device) -> dict:
    """``{key: float32 tensor}`` on ``device``: one draw of N(0, 1) for
    the whole model, each leaf a slice of it, scaled and shifted."""
    leaves = spec(cfg)
    total = sum(torch.Size(s).numel() for _, s, _, _ in leaves)
    z = torch.randn(total, generator=generator(seed, 3, device),
                    device=device, dtype=torch.float32)
    out, at = {}, 0
    for key, shape, std, mean in leaves:
        k = torch.Size(shape).numel()
        out[key] = z[at:at + k].view(shape).mul_(std).add_(mean)
        at += k
    return out
