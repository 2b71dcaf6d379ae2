"""Device-idle ms a step inside the program's `straps.train.update` span:
the regressor's forward, backward, Adam and metrics."""

from portbench.spans import span_idle_ms


def read(ctx):
    return span_idle_ms(ctx, "straps.train.update")
