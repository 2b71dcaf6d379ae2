"""Host ms a call in the program's `straps.predict.figures` span: the 3D
scatter figures (`write_verts_vis`)."""

from portbench.spans import span_host_ms


def read(ctx):
    return span_host_ms(ctx, "straps.predict.figures")
