"""The system under test, built through the program's own entry points
from the benchmark's weights: the port's modules
(``vit_spoof_detection_pda_tpu_torch``), nothing else of it."""

from __future__ import annotations

import torch


def module(cfg, weights: dict, device, dtype=torch.float32):
    """The port's model of the configuration's head, made on ``device``
    and loaded with ``weights`` (timm keys, float32), in eval mode."""
    from vit_spoof_detection_pda_tpu_torch.models.vit import (ViTAntiSpoof,
                                                               ViTLinearHead)
    geom = dict(patch_size=cfg["patch_size"], embed_dim=cfg["hidden_size"],
                depth=cfg["num_hidden_layers"],
                num_heads=cfg["num_attention_heads"],
                img_size=cfg["image_size"])
    with torch.device(device):
        if cfg["head"] == "linear":
            m = ViTLinearHead(num_classes=cfg["num_labels"], dtype=dtype,
                              **geom)
        else:
            m = ViTAntiSpoof(mlp_ratio=cfg["intermediate_size"]
                             / cfg["hidden_size"],
                             hidden=cfg["head_hidden_size"],
                             num_classes=cfg["num_labels"],
                             dropout=cfg["head_dropout"],
                             norm_eps=cfg["layer_norm_eps"], gelu="erf",
                             dtype=dtype, **geom)
    m.load_state_dict(weights, strict=True)
    return m.eval()


def dtype_of(name: str):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]
