"""Kernel 1 (``csrc/attention_block.cu``): its bound at the cell's batch
over the median device time of a call of the program's
``fused_attention_block_padded``."""

from padbench.readers import roofline_by_call


def read(ctx):
    return roofline_by_call(ctx, "ops/attention.py:fused_attention_block_padded",
                            "attention_block", ctx.traffic["batch"])
