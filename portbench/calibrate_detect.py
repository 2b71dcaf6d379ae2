"""The readings the photo path's limits are set from, on the card:

    python3 -m portbench.calibrate_detect --workload r18_predict_pointrend800 \\
        --seeds 1,2,... [--control-seeds 3,4,5] [--out FILE]

For each seed: set-up as a run makes it (no measured window; its first
call is the program's reading), the reference, and the program's numbers
against it.  Then the
regressor's control: the reference regressor on the reference's proxies
with its encoder on float8 e4m3 operands and every float32 product in
TF32 (the cached predict cell's control, the step below the
configuration's bfloat16 encoder), and each image's vertex and camera
gaps on both sides.  For each control seed besides:

- the control: the reference with both detectors' backbone and FPN in
  bfloat16, the step below the configuration's float32;
- the two planted faults, each a program call with the port changed
  (`FAULTS`).

One JSON line a seed and side, with the reference's silhouette coverage;
the limits (`limits/<workload>.json`) lie between the program's largest
reading and the smallest of the controls and faults that exceed it.
"""

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from portbench import compare_detect, harness


def _second(areas: np.ndarray) -> int:
    order = np.argsort(-areas, kind="stable")
    return int(order[1]) if len(order) > 1 and areas[order[1]] > 0 else int(order[0])


def _coarse_only(head, coarse, p2, boxes, image_index, steps=5, num_points=784, channel=0):
    """PointRend without its subdivision: the coarse 7x7 logits upsampled."""
    return F.interpolate(coarse[:, channel:channel + 1], scale_factor=2 ** steps,
                         mode="bilinear", align_corners=False)


def _second_mask(masks, valid, orig_w, orig_h):
    m = np.asarray(masks)
    return _second(np.where(np.asarray(valid).astype(bool), m.sum(axis=(1, 2)), -1.0))


def _second_box(boxes, valid, orig_w, orig_h):
    b = np.asarray(boxes)
    area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return _second(np.where(np.asarray(valid).astype(bool), area, -1.0))


# Planted faults: (module, name, replacement) of the port.
FAULTS = {
    "no_subdivision": [("straps_tpu_torch.perception.rcnn", "subdivision_inference",
                        _coarse_only)],
    "second_largest": [("straps_tpu_torch.perception.frontend",
                        "get_largest_centred_mask_index", _second_mask),
                       ("straps_tpu_torch.perception.frontend",
                        "get_largest_centred_box_index", _second_box)],
}


@contextlib.contextmanager
def planted(fault: str):
    import importlib

    saved = []
    try:
        for module, name, fn in FAULTS[fault]:
            mod = importlib.import_module(module)
            saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def faulted_outputs(drv, fault: str) -> dict:
    """One program call with the fault planted: its proxies and predictions."""
    drv.calls = []
    with planted(fault):
        drv.unit()
    return drv.program_outputs()


def readings(cell, seed: int, control: bool, device: str = "cuda") -> list:
    """[(side, numbers)] of one seed."""
    out = []
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
        drv = cell.driver().Driver(cell, seed, device, tmp)
        prog = drv.program_outputs()
        ref = drv.reference()
        cover = {"ref_sil_share": float(np.mean(ref["sils"])),
                 "ref_empty_sils": int((ref["sils"].reshape(len(ref["sils"]), -1).sum(1) == 0)
                                       .sum())}
        out.append(("program", {**compare_detect.detect_numbers(prog, ref), **cover}))
        low_regressor = dict(ref, calls=[drv.regress(ref["sils"], ref["joints"], fp8=True)])
        out.append(("regressor_control", compare_detect.detect_numbers(low_regressor, ref)))
        out.append(("image_gaps", {
            f"{side}_{key}": np.round(compare_detect.image_gaps(o, ref, key), 8).tolist()
            for side, o in (("program", prog), ("regressor_control", low_regressor))
            for key in ("verts", "cam_wp")}))
        if control:
            low = drv.reference(trunk_dtype=torch.bfloat16)
            out.append(("control", compare_detect.detect_numbers(low, ref)))
            for fault in FAULTS:
                out.append((f"fault_{fault}",
                            compare_detect.detect_numbers(faulted_outputs(drv, fault), ref)))
        del drv
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = harness.Cell(harness.load_json("BENCHMARK.json"), args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    sink = open(args.out, "a") if args.out else None
    for seed in sorted(set(seeds) | control):
        t = time.perf_counter()
        for side, numbers in readings(cell, seed, seed in control):
            line = json.dumps({"workload": args.workload, "seed": seed, "side": side, **numbers})
            print(line, flush=True)
            if sink:
                print(line, file=sink, flush=True)
        print(f"seed {seed}: {time.perf_counter() - t:.1f} s", file=sys.stderr, flush=True)
    found = harness.forbidden_modules()
    if found:
        print(f"modules that a run may not load: {found}", file=sys.stderr)
        return 5
    return 0


if __name__ == "__main__":
    sys.exit(main())
