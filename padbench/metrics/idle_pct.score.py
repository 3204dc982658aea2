"""The device's idle share over the traced stretch (moves the end-to-end
metric of the score cells)."""

from padbench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
