"""GELU in the two forms the JAX package uses (counterpart of
``ops/gelu.py``), and :class:`GeluLean`, the GELU whose backward keeps
only the input.

Both forms follow ``jax.nn.gelu`` term by term so the port rounds where
JAX does: ``x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3)))`` for
the tanh form, ``0.5 * x * erfc(-x / sqrt(2))`` for the exact one.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)
_SQRT_HALF = math.sqrt(0.5)


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    if approximate:
        cdf = 0.5 * (1.0 + torch.tanh(
            _SQRT_2_OVER_PI * (x + 0.044715 * (x * x * x))))
        return x * cdf
    return 0.5 * x * torch.erfc(-x * _SQRT_HALF)


class GeluLean(torch.autograd.Function):
    """GELU that saves only its input and recomputes the gate in the
    backward (the JAX ``gelu_lean``): one ``[rows, hidden]`` tensor kept
    for the backward instead of autograd's input, gate and output.
    PyTorch's fused ``gelu`` and ``gelu_backward`` compute in f32 and
    round once to ``x``'s dtype; they write the exact form with
    ``1 + erf`` where JAX writes ``erfc``, a difference of f32 ulps."""

    @staticmethod
    def forward(ctx, x, approximate: bool = False):
        ctx.mode = "tanh" if approximate else "none"
        ctx.save_for_backward(x)
        return F.gelu(x, approximate=ctx.mode)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return (torch.ops.aten.gelu_backward(g, x, approximate=ctx.mode),
                None)


def gelu_lean(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    return GeluLean.apply(x, approximate)


class GELU(nn.Module):
    """:func:`gelu` as a module (no parameters, so no state-dict keys)."""

    def __init__(self, approximate: bool = False):
        super().__init__()
        self.approximate = approximate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gelu(x, self.approximate)
