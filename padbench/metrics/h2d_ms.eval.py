"""Device time of the host-to-device copies per batch (the runner's
pinned upload) over the traced stretch of the f32 evaluation cell."""

from padbench.readers import h2d_ms


def read(ctx):
    return h2d_ms(ctx, "batch")
