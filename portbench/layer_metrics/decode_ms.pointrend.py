"""Host ms a call in the program's `straps.predict.decode` span: every
photo decoded (PNG and JPEG), padded to a square and resized to 512."""

from portbench.spans import span_host_ms


def read(ctx):
    return span_host_ms(ctx, "straps.predict.decode")
