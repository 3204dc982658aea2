"""Where the port runs, and the f32 matmul precision of its plain paths.

The port's entry points run on the CUDA card unless the caller asks for
the CPU with ``device="cpu"``; without a card they raise instead of
quietly running elsewhere (the JAX package's ``make_serving_fn`` raises
off-TPU the same way unless ``interpret=True``).
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Raises if a CUDA device is asked for and
    this machine has none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the port runs on a CUDA card and none is available; pass "
            "device='cpu' to run its plain PyTorch versions")
    return device


@contextlib.contextmanager
def exact_f32_matmul():
    """Turn TF32 off for f32 matmuls and cuDNN convolutions, and restore
    the previous setting after.

    The plain versions and the stem/head GEMMs form f32 products of
    bf16-rounded (or f32) operands, as the JAX code's
    ``preferred_element_type=float32`` dots do; TF32 would round the
    operands to 10 mantissa bits on the card.  The flags are
    process-wide, so this must not overlap a TF32 computation on another
    thread."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
