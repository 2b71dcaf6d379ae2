"""The regressor's FLOPs a unit as a share of the dense bfloat16 peak."""

from portbench.readers import mfu_pct


def read(ctx):
    return mfu_pct(ctx)
