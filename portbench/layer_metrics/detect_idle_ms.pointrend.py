"""Device-idle ms a call inside the program's `straps.detect.keypoint` and
`straps.detect.silhouette` spans: the host's launches, NMS rounds, ROI-size
syncs and pulls that leave the card waiting during the detectors."""

from portbench.detect_readers import idle_ms


def read(ctx):
    return idle_ms(ctx, "straps.detect.keypoint", "straps.detect.silhouette")
