"""The device's idle share over the traced stretch (moves the end-to-end
metric of the train cells)."""

from padbench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
