"""GELU forward in the two forms the JAX package uses (counterpart of
``ops/gelu.py``; its lean VJP comes with training).

Both follow ``jax.nn.gelu`` term by term so the port rounds where JAX
does: ``x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3)))`` for the
tanh form, ``0.5 * x * erfc(-x / sqrt(2))`` for the exact one.
"""

from __future__ import annotations

import math

import torch
from torch import nn

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)
_SQRT_HALF = math.sqrt(0.5)


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    if approximate:
        cdf = 0.5 * (1.0 + torch.tanh(
            _SQRT_2_OVER_PI * (x + 0.044715 * (x * x * x))))
        return x * cdf
    return 0.5 * x * torch.erfc(-x * _SQRT_HALF)


class GELU(nn.Module):
    """:func:`gelu` as a module (no parameters, so no state-dict keys)."""

    def __init__(self, approximate: bool = False):
        super().__init__()
        self.approximate = approximate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gelu(x, self.approximate)
