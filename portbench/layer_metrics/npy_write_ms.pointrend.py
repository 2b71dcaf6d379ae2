"""Host ms a call in the program's `straps.predict.write_npy` span on the
photo path: the npy files of every image's predictions (no PNG is
written: the cell runs without figures)."""

from portbench.spans import span_host_ms


def read(ctx):
    return span_host_ms(ctx, "straps.predict.write_npy")
