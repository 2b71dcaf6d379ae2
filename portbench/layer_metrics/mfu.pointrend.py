"""Both detectors' and the regressor's FLOPs a call
(`detector_counters.predict_call_flops`) over the unprofiled wall a call,
as a share of the dense bfloat16 peak."""

from portbench.readers import mfu_pct


def read(ctx):
    return mfu_pct(ctx)
