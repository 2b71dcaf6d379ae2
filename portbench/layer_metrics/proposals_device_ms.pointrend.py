"""Device-busy ms a call inside the program's `straps.detect.proposals`
spans: the RPN head, the anchors, each level's top-k and the proposals'
NMS, both detectors."""

from portbench.detect_readers import busy_ms


def read(ctx):
    return busy_ms(ctx, "straps.detect.proposals")
