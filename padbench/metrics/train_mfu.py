"""The training step's share of the bf16 peak: three times the forward's
operations of every step that started in the traced stretch, over the
stretch."""

from padbench import work
from padbench.readers import stretch_mfu


def read(ctx):
    return stretch_mfu(ctx, "step", ctx.traffic["batch"]
                       * work.train_flops(ctx.config))
