"""ResNet50 classifier, the reference's baseline (counterpart of the JAX
package's ``models/resnet.py``).

torchvision's ``resnet50`` with a ``num_classes``-way fc: the modules
carry torchvision's key set, so a torchvision ``.pth`` loads with
``strict=True``, and the JAX ``batch_stats`` land in the BatchNorms'
running statistics (``models/convert.py::resnet50_to_torch``).  The input
is NHWC, as in the JAX package; the convolutions run in NCHW through
``torch.nn.functional.conv2d`` (cuDNN on the card; the JAX package leaves
them to XLA, outside any Pallas kernel).  ``dtype`` is the compute
policy: weights cast to ``dtype`` at use, BatchNorm in f32 and written in
``dtype``, the fc in f32.  Eval mode uses the running statistics; train
mode the batch's, as torchvision does.  Hold f32 numerics with TF32 off
(``device.exact_f32_matmul``): cuDNN runs f32 convolutions in TF32 by
default.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def _conv(x, conv: nn.Conv2d, dtype) -> torch.Tensor:
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), None, conv.stride,
                    conv.padding)


def _bn(x, bn: nn.BatchNorm2d, dtype) -> torch.Tensor:
    return bn(x.float()).to(dtype)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 bottleneck with an identity or
    projection shortcut (torchvision's v1.5 layout)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 project: bool = False, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = (nn.Sequential(
            nn.Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False),
            nn.BatchNorm2d(planes * 4)) if project else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = _bn(_conv(x, self.conv1, dt), self.bn1, dt).relu()
        y = _bn(_conv(y, self.conv2, dt), self.bn2, dt).relu()
        y = _bn(_conv(y, self.conv3, dt), self.bn3, dt)
        if self.downsample is not None:
            conv, bn = self.downsample
            x = _bn(_conv(x, conv, dt), bn, dt)
        return (y + x).relu()


class ResNet50(nn.Module):
    """ResNet50-v1 with a ``num_classes``-way fc head."""

    def __init__(self, num_classes: int = 2,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        inplanes, planes = 64, 64
        for stage, n_blocks in enumerate(stage_sizes):
            blocks = []
            for block in range(n_blocks):
                stride = 2 if stage > 0 and block == 0 else 1
                blocks.append(Bottleneck(inplanes, planes, stride,
                                         project=block == 0, dtype=dtype))
                inplanes = planes * 4
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
            planes *= 2
        self.n_stages = len(stage_sizes)
        self.fc = nn.Linear(inplanes, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: ``[B, H, W, 3]`` normalized floats -> f32 logits
        ``[B, num_classes]``."""
        dt = self.dtype
        x = x.to(dt).permute(0, 3, 1, 2)
        x = _bn(_conv(x, self.conv1, dt), self.bn1, dt).relu()
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for stage in range(self.n_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        x = x.mean((2, 3)).float()                   # global average pool
        return F.linear(x, self.fc.weight.float(), self.fc.bias.float())
