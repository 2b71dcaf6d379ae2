"""Device ms a step of the synthetic batch: draws, SMPL, the packed render,
crop, proxy (the benchmark's `portbench.synth` range)."""

from portbench.readers import range_device_ms


def read(ctx):
    return range_device_ms(ctx, "synth")
