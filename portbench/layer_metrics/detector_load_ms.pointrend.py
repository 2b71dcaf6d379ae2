"""Host ms a call in the program's `straps.detect.build` spans: each
detector's detectron2 pickle read, its tensors given to the model and
moved to the card."""

from portbench.spans import span_host_ms


def read(ctx):
    return span_host_ms(ctx, "straps.detect.build")
