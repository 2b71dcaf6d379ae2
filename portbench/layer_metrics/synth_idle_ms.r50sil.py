"""Device-idle ms a step inside the program's `straps.train.synth` span:
the synthetic batch's SMPL, render and proxy stages, with the host's
launches and syncs between them."""

from portbench.spans import span_idle_ms


def read(ctx):
    return span_idle_ms(ctx, "straps.train.synth")
