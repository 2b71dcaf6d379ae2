"""Blocking sync calls a call inside the program's `straps.detect.*` spans
(stream, device and event synchronisations, synchronous copies); the note
splits them by span and gives the NMS fixpoint rounds of the port's
counter (`perception/ops.py::NMS_STATS`)."""

from portbench.detect_readers import detect_syncs


def read(ctx):
    return detect_syncs(ctx)
