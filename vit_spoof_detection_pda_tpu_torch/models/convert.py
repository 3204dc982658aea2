"""Weights between the JAX-layout parameter tree and the port's modules
(the port's own copy of the JAX package's ``models/convert.py`` export
path, pure numpy).

- :func:`antispoof_to_torch`: ``{"params": {"vit": ..., "head": ...}}``
  (``[in, out]`` kernels) -> the published checkpoint's key set
  (``vit.<timm names>`` + ``classifier.{0,2,5}``).
- :func:`antispoof_from_torch`: the inverse, used by the serving path to
  lay the module's weights out for the kernels.
- :func:`load_jax_params`: load a JAX-layout tree into a port
  ``ViTAntiSpoof`` with ``strict=True``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _np(x) -> np.ndarray:
    """torch tensor | array -> float32 numpy (detached, contiguous)."""
    if hasattr(x, "detach"):
        # .float() first: numpy() raises on torch bfloat16 tensors
        x = x.detach().float().cpu().numpy()
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32))


def vit_backbone_to_timm(params, prefix: str = "", patch_size: int = 16,
                         channels: int = 3) -> dict:
    """ViT params -> flat timm-named numpy state dict
    (``{prefix}patch_embed.proj.weight`` etc.)."""
    def lin(p):
        return {"weight": _np(p["kernel"]).T, "bias": _np(p["bias"])}

    def ln(p):
        return {"weight": _np(p["scale"]), "bias": _np(p["bias"])}

    sd = {}
    k = _np(params["patch_embed"]["kernel"])             # [p*p*c, D]
    d = k.shape[1]
    inferred = round((k.shape[0] / channels) ** 0.5)
    if inferred * inferred * channels == k.shape[0]:
        patch_size = inferred        # export any patch size, not just 16
    elif patch_size * patch_size * channels != k.shape[0]:
        raise ValueError(
            f"patch kernel rows {k.shape[0]} match neither the inferred "
            f"square patch nor patch_size={patch_size} x {channels}ch")
    sd[f"{prefix}patch_embed.proj.weight"] = k.reshape(
        patch_size, patch_size, channels, d).transpose(3, 2, 0, 1)
    sd[f"{prefix}patch_embed.proj.bias"] = _np(params["patch_embed"]["bias"])
    sd[f"{prefix}cls_token"] = _np(params["cls_token"])
    sd[f"{prefix}pos_embed"] = _np(params["pos_embed"])
    for key, val in ln(params["norm"]).items():
        sd[f"{prefix}norm.{key}"] = val
    i = 0
    while f"block{i}" in params:
        blk = params[f"block{i}"]
        flat = {
            f"blocks.{i}.norm1": ln(blk["norm1"]),
            f"blocks.{i}.attn.qkv": lin(blk["attn"]["qkv"]),
            f"blocks.{i}.attn.proj": lin(blk["attn"]["proj"]),
            f"blocks.{i}.norm2": ln(blk["norm2"]),
            f"blocks.{i}.mlp.fc1": lin(blk["mlp"]["fc1"]),
            f"blocks.{i}.mlp.fc2": lin(blk["mlp"]["fc2"]),
        }
        for mod, parts in flat.items():
            for key, val in parts.items():
                sd[f"{prefix}{mod}.{key}"] = val
        i += 1
    return sd


def antispoof_to_torch(variables) -> dict:
    """ViTAntiSpoof variables -> the published checkpoint's key set
    (``vit.<timm>`` backbone + head as ``classifier.{0,2,5}``)."""
    params = variables["params"] if "params" in variables else variables
    sd = vit_backbone_to_timm(params["vit"], prefix="vit.")
    head = params["head"]
    sd["classifier.0.weight"] = _np(head["norm"]["scale"])
    sd["classifier.0.bias"] = _np(head["norm"]["bias"])
    sd["classifier.2.weight"] = _np(head["fc1"]["kernel"]).T
    sd["classifier.2.bias"] = _np(head["fc1"]["bias"])
    sd["classifier.5.weight"] = _np(head["fc2"]["kernel"]).T
    sd["classifier.5.bias"] = _np(head["fc2"]["bias"])
    return sd


def _linear(sd: Mapping, name: str) -> dict:
    return {"kernel": _np(sd[f"{name}.weight"]).T,
            "bias": _np(sd[f"{name}.bias"])}


def _layernorm(sd: Mapping, name: str) -> dict:
    return {"scale": _np(sd[f"{name}.weight"]),
            "bias": _np(sd[f"{name}.bias"])}


def vit_backbone_from_timm(sd: Mapping, prefix: str = "") -> dict:
    """timm-named ViT state dict -> JAX-layout ViT params (numpy).  The
    patch conv ``[D, C, p, p]`` flattens to the ``[p*p*C, D]`` patch-GEMM
    kernel in (row, column, channel) order; depth is read off the keys.
    A missing key raises ``KeyError``."""
    p = prefix
    conv_w = _np(sd[f"{p}patch_embed.proj.weight"])
    params = {
        "patch_embed": {
            "kernel": np.ascontiguousarray(
                conv_w.transpose(2, 3, 1, 0).reshape(-1, conv_w.shape[0])),
            "bias": _np(sd[f"{p}patch_embed.proj.bias"])},
        "cls_token": _np(sd[f"{p}cls_token"]),
        "pos_embed": _np(sd[f"{p}pos_embed"]),
        "norm": _layernorm(sd, f"{p}norm"),
    }
    i = 0
    while f"{p}blocks.{i}.norm1.weight" in sd:
        b = f"{p}blocks.{i}"
        params[f"block{i}"] = {
            "norm1": _layernorm(sd, f"{b}.norm1"),
            "attn": {"qkv": _linear(sd, f"{b}.attn.qkv"),
                     "proj": _linear(sd, f"{b}.attn.proj")},
            "norm2": _layernorm(sd, f"{b}.norm2"),
            "mlp": {"fc1": _linear(sd, f"{b}.mlp.fc1"),
                    "fc2": _linear(sd, f"{b}.mlp.fc2")},
        }
        i += 1
    return params


def antispoof_from_torch(sd: Mapping) -> dict:
    """Published-checkpoint state dict (``vit.*`` + ``classifier.{0,2,5}``)
    -> ``{"params": ...}`` in the JAX layout (numpy)."""
    return {"params": {
        "vit": vit_backbone_from_timm(sd, prefix="vit."),
        "head": {"norm": _layernorm(sd, "classifier.0"),
                 "fc1": _linear(sd, "classifier.2"),
                 "fc2": _linear(sd, "classifier.5")},
    }}


def load_jax_params(module: torch.nn.Module, params) -> torch.nn.Module:
    """Load a JAX-layout ViTAntiSpoof tree (``{"params": ...}`` or the
    bare params) into the port's ``ViTAntiSpoof`` with ``strict=True``;
    returns the module."""
    sd = {k: torch.tensor(v) for k, v in antispoof_to_torch(params).items()}
    module.load_state_dict(sd, strict=True)
    return module
