"""Host ms a call in the program's `straps.predict.load` span on the photo
path: the body model, the regressor's build and its checkpoint load."""

from portbench.spans import span_host_ms


def read(ctx):
    return span_host_ms(ctx, "straps.predict.load")
