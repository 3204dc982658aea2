"""The device's idle share over the traced stretch (moves the end-to-end
metric of the f32 evaluation cell)."""

from padbench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
