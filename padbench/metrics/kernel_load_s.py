"""Seconds of set-up in the first load of each of the program's kernel
libraries (the sources' hash, nvcc where not built, the ``ctypes``
load): the program's span totals of ``vsd.kernels.load``."""

from padbench.spans import span_total_s


def read(ctx):
    return span_total_s("vsd.kernels.load")
