"""Image normalization on tensors (counterpart of the JAX package's
``ops/image.py``).

Images stay NHWC, the JAX package's layout, so the two can be compared
directly.  The resize-based eval preprocessing comes with the
augmentation slice.
"""

from __future__ import annotations

import torch

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


def normalize_u8_fused(batch_u8: torch.Tensor,
                       dtype=torch.bfloat16) -> torch.Tensor:
    """uint8 -> normalized ``dtype`` as one affine in f32:
    ``(u8 - 255*mean) * (1 / (255*std))``."""
    dev = batch_u8.device
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=dev) * 255.0
    inv_std = 1.0 / (torch.tensor(IMAGENET_STD, dtype=torch.float32,
                                  device=dev) * 255.0)
    return ((batch_u8.to(torch.float32) - mean) * inv_std).to(dtype)
