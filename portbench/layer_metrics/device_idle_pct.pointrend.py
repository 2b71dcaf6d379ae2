"""The device's idle share of a predict call over photos, from the traced
stretch."""

from portbench.readers import device_idle_pct


def read(ctx):
    return device_idle_pct(ctx)
