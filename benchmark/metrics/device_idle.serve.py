"""Percent of the traced window in which no operation ran on the device."""
from benchmark.metrics._kernels import idle_share


def read(ctx):
    return idle_share(ctx)
