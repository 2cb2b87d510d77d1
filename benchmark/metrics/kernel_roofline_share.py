"""Percent: the least time of every hand-written kernel launch in the
traced calls (``benchmark/counts/``) over the device time the profiler gives
those kernels."""

from benchmark.roofline import kernel_share


def read(run):
    return kernel_share(run)
