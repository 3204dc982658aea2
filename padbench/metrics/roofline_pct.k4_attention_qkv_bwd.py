"""Kernel 4 (``csrc/attention_qkv_bwd.cu``): its bound at the cell's
batch over the device time of a launch of its kernel, read by name."""

from padbench.readers import roofline_by_name

KERNEL = r"onchip_bwd_kernel"


def read(ctx):
    return roofline_by_name(ctx, KERNEL, "attention_qkv_bwd",
                            ctx.traffic["batch"])
