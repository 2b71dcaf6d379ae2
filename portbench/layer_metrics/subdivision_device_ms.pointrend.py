"""Device-busy ms a call inside the program's `straps.detect.mask` spans:
PointRend's coarse head, its five subdivision steps and the mask paste."""

from portbench.detect_readers import busy_ms


def read(ctx):
    return busy_ms(ctx, "straps.detect.mask")
