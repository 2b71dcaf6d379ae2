"""The readings a cell's limits are set from, on the card:

    python3 -m portbench.calibrate --workload <name> --seeds 1,2,... \\
        [--control-seeds 3,4,5] [--out FILE]

For each seed: set-up as a run makes it (no measured window), then the
program's numbers against the reference.  For each control seed also the
control's: the reference put in the program's place in the precision
below the configuration's (every float32 product in TF32, the encoder's
convolutions on float8 e4m3 inputs and weights), and for training cells
the planted fault of a loss over half of each batch (the per-frame metrics
still over all of it).  One JSON line a seed
and side; the limits (`limits/<workload>.json`) lie between the program's
largest reading and the control's smallest.
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

from portbench import compare, harness


def _tf32_round(t):
    """float32 values rounded to TF32's 10-bit mantissa (to nearest); the
    gradient passes through the rounding unchanged."""
    if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
        return t
    bits = t.detach().contiguous().view(torch.int32)
    return t + (((bits + 0x1000) & ~0x1FFF).view(torch.float32) - t.detach())


@contextlib.contextmanager
def tf32():
    """Every float32 product in TF32: the card's own mode, and on the CPU,
    which has none, the products' inputs rounded to TF32 first."""
    import torch.nn.functional as F

    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    patched = [(torch, n) for n in ("matmul", "bmm", "einsum")] + [(F, "linear"), (F, "conv2d")]
    saved = [getattr(mod, n) for mod, n in patched]

    def rounding(fn):
        def call(*args, **kwargs):
            return fn(*(_tf32_round(a) for a in args),
                      **{k: _tf32_round(v) for k, v in kwargs.items()})
        return call

    if not torch.cuda.is_available():
        for (mod, n), fn in zip(patched, saved):
            setattr(mod, n, rounding(fn))
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
        for (mod, n), fn in zip(patched, saved):
            setattr(mod, n, fn)


def train_detail(prog: dict, ref: dict) -> dict:
    """Where a training reading comes from: the worst leaves, the losses,
    each step's task-loss gaps, and every leaf's norms on both sides."""
    med_g = float(np.median(list(ref["grad1"].values())))
    keep = compare.moved_leaves(ref["grad1"])
    med_c = float(np.median([ref["change"][k] for k in keep]))

    def worst(p, r, keys, med):
        k = max(keys, key=lambda k: abs(p[k] - r[k]) / max(r[k], med, 1e-30))
        return [k, p[k], r[k], med]

    return {"grad_worst": worst(prog["grad1"], ref["grad1"], list(ref["grad1"]), med_g),
            "change_worst": worst(prog["change"], ref["change"], keep, med_c),
            "left_out": sorted(set(ref["grad1"]) - set(keep)),
            "losses": [prog["losses"], ref["losses"]], "task_gaps": compare.task_gaps(prog, ref),
            "grad1": prog["grad1"], "change": prog["change"], "ref_grad1": ref["grad1"],
            "ref_change": ref["change"],
            **compare.train_unused(prog, ref)}


def readings(cell, seed: int, control: bool, device: str = "cuda") -> list:
    """[(side, numbers)] of one seed: the program, and with `control` the
    control and, for training, the half-batch fault."""
    kind = cell.traffic["kind"]
    out = []
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
        drv = cell.driver().Driver(cell, seed, device, tmp)
        prog = drv.program_outputs()
        if kind == "train":
            drv.release()
            ref = drv.reference()
            out.append(("program", compare.train_numbers(prog, ref)))
            out.append(("program_detail", train_detail(prog, ref)))
            if control:
                with tf32():
                    low = drv.reference(fp8=True)
                out.append(("control", compare.train_numbers(low, ref)))
                out.append(("control_detail", train_detail(low, ref)))
                half = drv.reference(half=True)
                out.append(("half_batch", compare.train_numbers(half, ref)))
                out.append(("half_batch_detail", train_detail(half, ref)))
        else:
            calls, files, fg = prog
            ref, ref_fg = drv.reference()
            out.append(("program", compare.predict_numbers(calls, files, ref, fg, ref_fg)))
            if control:
                with tf32():
                    low, low_fg = drv.reference(fp8=True)
                out.append(("control", compare.predict_numbers([low], low, ref, low_fg,
                                                               ref_fg)))
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
    p.add_argument("--float32", action="store_true",
                   help="run the program's encoder in float32: a witness of what the "
                        "configuration's bfloat16 alone makes of a reading")
    args = p.parse_args(argv)
    cell = harness.Cell(harness.load_json("BENCHMARK.json"), args.workload)
    if args.float32:
        cell.config["model"]["compute_dtype"] = None
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    sink = open(args.out, "a") if args.out else None
    for seed in sorted(set(seeds) | control):
        t = time.perf_counter()
        for side, numbers in readings(cell, seed, seed in control):
            line = json.dumps({"workload": args.workload, "seed": seed,
                               "side": side + ("_float32" if args.float32 else ""), **numbers})
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
