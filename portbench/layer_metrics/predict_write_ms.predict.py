"""Host ms a call in the program's `straps.predict.write_npy` and
`straps.predict.write_png` spans: the npy files and the PNG renders."""

from portbench.spans import span_host_ms


def read(ctx):
    return span_host_ms(ctx, "straps.predict.write_npy", "straps.predict.write_png")
