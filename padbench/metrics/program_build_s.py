"""Seconds of set-up in building the program (the serving weights, the
training state and apply function): the program's span totals of
``vsd.build.*``, less the kernel loads nested in them."""

from padbench.spans import span_total_s


def read(ctx):
    return span_total_s("vsd.build.")
