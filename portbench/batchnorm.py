"""The training-mode BatchNorm kernels' yardstick: the elements the
encoder's BatchNorm layers normalise, counted from the configuration's
depth and image size (torchvision's widths, as `counters.regressor_macs`),
and their least time, 10 bytes an element over HBM bandwidth: forward, x
read once and y written once; backward, dy and x read once and dx written
once, bfloat16.  The reader finds the kernels in the trace by name."""

import os

from portbench import counters, harness

BYTES_PER_ELEMENT = 10
KERNEL_NAME = "straps_batchnorm_"


def batchnorm_elements(depth: int, img_wh: int) -> int:
    """Elements of one sample that the encoder's BatchNorm layers
    normalise: the stem's, each block's (BasicBlock: two; Bottleneck:
    three, the first before the stride) and each downsampling branch's."""
    kind, layers = counters._BLOCKS[depth]
    size = counters._out(img_wh, 7, 2, 3)
    total = 64 * size * size
    size = counters._out(size, 3, 2, 1)                  # max pool
    cin = 64
    for stage, n in enumerate(layers):
        planes = 64 * 2 ** stage
        for b in range(n):
            stride = 2 if stage > 0 and b == 0 else 1
            o = counters._out(size, 3, stride, 1)
            if kind == "basic":
                cout = planes
                total += 2 * planes * o * o
            else:
                cout = planes * 4
                total += planes * size * size + planes * o * o + cout * o * o
            if stride != 1 or cin != cout:
                total += cout * o * o
            cin, size = cout, o
    return total


def batchnorm_roofline_pct(ctx, workload: str):
    """The least time of a unit's BatchNorm work (the cell's depth, image
    size and batch) over the device time of the kernels named
    `straps_batchnorm_*` in the traced units, in %; None where none ran."""
    kernels = ctx.trace.kernels(KERNEL_NAME)
    if not kernels:
        ctx.notes.append("batchnorm: no straps_batchnorm_ kernels in the trace")
        return None
    cell = harness.Cell(harness.load_json(os.path.join(os.path.dirname(harness.HERE),
                                                       "BENCHMARK.json")), workload)
    elements = batchnorm_elements(int(cell.config["model"]["resnet_layers"]),
                                  int(cell.config["img_wh"])) * int(cell.traffic["batch_size"])
    least = BYTES_PER_ELEMENT * elements / counters.HBM_BYTES_S
    device = sum(float(e.get("dur", 0)) for e in kernels) * 1e-6 / ctx.units
    by_name = {}
    for e in kernels:
        name = e.get("name", "")
        key = name[name.index(KERNEL_NAME):].split("<")[0].split("(")[0]
        by_name[key] = by_name.get(key, 0) + 1
    ctx.notes.append(
        f"batchnorm: {len(kernels) / ctx.units:g} launches a unit ("
        + ", ".join(f"{k} {v / ctx.units:g}" for k, v in sorted(by_name.items()))
        + f"), {device * 1e3:.6f} ms a unit, least {least * 1e3:.6f} ms by bytes "
        f"({elements} elements x {BYTES_PER_ELEMENT} B)")
    return 100.0 * least / device
