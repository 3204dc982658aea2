"""The f32 scoring step's share of the f32 peak (67 TFLOP/s, TF32 off):
the model's operations of every batch that started in the traced
stretch, over the stretch."""

from padbench import work
from padbench.readers import stretch_mfu


def read(ctx):
    return stretch_mfu(ctx, "batch", ctx.traffic["batch"]
                       * work.forward_flops(ctx.config))
