"""The scoring step's share of the bf16 peak: the model's operations of
every batch that started in the traced stretch (197 tokens an image),
over the stretch."""

from padbench import work
from padbench.readers import stretch_mfu


def read(ctx):
    return stretch_mfu(ctx, "batch", ctx.traffic["batch"]
                       * work.forward_flops(ctx.config))
