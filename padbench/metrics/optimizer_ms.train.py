"""Device time per step of the clip and AdamW's ``torch._foreach``
kernels (``multi_tensor_apply``) over the traced stretch."""

from padbench.readers import kernels_ms


def read(ctx):
    return kernels_ms(ctx, r"multi_tensor_apply", "step")
