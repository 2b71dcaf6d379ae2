"""Device-busy ms a call inside the program's `straps.detect.keypoint` and
`straps.detect.silhouette` spans: both detectors' forwards over every chunk,
with their pulls to the host."""

from portbench.detect_readers import busy_ms


def read(ctx):
    return busy_ms(ctx, "straps.detect.keypoint", "straps.detect.silhouette")
