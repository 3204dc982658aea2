"""The f32 attention that the module path launches (kernel 8,
``csrc/attention_qkv.cu``): its bound at the cell's batch over the device
time of a launch, read by kernel name."""

from padbench.readers import roofline_by_name

KERNEL = r"vsd::.*self_\w*f32\w*_kernel"


def read(ctx):
    return roofline_by_name(ctx, KERNEL, "attention_qkv",
                            ctx.traffic["batch"])
