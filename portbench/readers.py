"""What the per-layer readers (`layer_metrics/<name>.py`) share: each
takes the traced stretch's context and returns a number, or None where
the trace holds nothing to read."""

from portbench import counters

# Kernel name parts and output bytes a pixel of each rasteriser.
RASTER = {"packed": (("raster", "PackedKeys"), 4), "faceid": (("raster", "FaceIdKeys"), 8)}


def device_idle_pct(ctx):
    """100 x (1 - busy / wall) a unit: busy is the union of the device's
    kernel, copy and memset intervals in the profiled units, wall the
    unprofiled units' mean."""
    busy = ctx.trace.busy_s() / ctx.units
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / ctx.wall_per_unit_s)


def mfu_pct(ctx):
    """The regressor's FLOPs a unit over the unprofiled wall a unit, as a
    share of the dense bfloat16 peak."""
    return 100.0 * ctx.flops_per_unit / ctx.wall_per_unit_s / counters.PEAK_BF16_FLOP_S


def launches_per_unit(ctx):
    n = ctx.trace.launches()
    return n / ctx.units if n else None


def range_device_ms(ctx, name):
    """Device ms a unit of the work launched inside the benchmark's range `name`."""
    s = ctx.trace.range_device_s(name)
    return 1e3 * s / ctx.units if s > 0 else None


def raster_roofline_pct(ctx, kind):
    """The kernel's least time over its device time, a launch on average:
    the least time from each recorded launch's inputs (`counters`), the
    device time from the trace's kernels of that name."""
    parts, out_bytes = RASTER[kind]
    kernels = ctx.trace.kernels(*parts)
    calls = ctx.raster.get(kind, [])
    if not kernels or not calls:
        return None
    least, sides = 0.0, set()
    for args in calls:
        planes, bounds = args[0], args[1]
        attr_bytes = args[2].numel() * 4 if kind == "packed" else 0
        img_h, img_w = args[-2], args[-1]
        t, side, nbytes, ops = counters.raster_least_time_s(planes, bounds.numel(), attr_bytes,
                                                            img_h, img_w, out_bytes)
        least += t
        sides.add(side)
    device = sum(float(e.get("dur", 0)) for e in kernels) * 1e-6
    ctx.notes.append(f"raster_{kind}: {len(calls)} launches recorded, {len(kernels)} kernels "
                     f"traced, {device / len(kernels) * 1e3:.6f} ms a launch, least "
                     f"{least / len(calls) * 1e3:.6f} ms bound by {'/'.join(sorted(sides))}")
    return 100.0 * (least / len(calls)) / (device / len(kernels))
