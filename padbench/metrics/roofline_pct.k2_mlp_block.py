"""Kernel 2 (``csrc/mlp_block.cu``): its bound at the cell's batch over
the median device time of a call of the program's ``fused_mlp_block``."""

from padbench.readers import roofline_by_call


def read(ctx):
    return roofline_by_call(ctx, "ops/attention.py:fused_mlp_block",
                            "mlp_block", ctx.traffic["batch"])
