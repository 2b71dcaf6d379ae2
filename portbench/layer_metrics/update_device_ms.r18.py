"""Device ms a step of the regressor's forward, backward, Adam and metrics
(the benchmark's `portbench.update` range)."""

from portbench.readers import range_device_ms


def read(ctx):
    return range_device_ms(ctx, "update")
