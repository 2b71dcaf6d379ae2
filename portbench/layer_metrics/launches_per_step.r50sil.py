"""Kernel launches a training step, counted in the traced steps."""

from portbench.readers import launches_per_unit


def read(ctx):
    return launches_per_unit(ctx)
