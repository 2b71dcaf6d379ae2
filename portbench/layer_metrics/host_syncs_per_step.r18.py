"""Blocking sync calls a training step inside the program's `straps.*`
spans (stream, device and event synchronisations, synchronous copies)."""

from portbench.spans import host_syncs_per_unit


def read(ctx):
    return host_syncs_per_unit(ctx)
