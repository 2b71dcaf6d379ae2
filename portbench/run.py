"""Run one cell of the port's benchmark and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Set-up (imports, inputs made from the seed,
the program built on the card, its first units, which the correctness
check reads) counts as `setup_s`; then units run for `--seconds`.  With
`--trace 0` the result carries the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics, read from a profiled stretch of units
after an unprofiled window.  After the window the program's outputs are
compared with the reference (`portbench/reference/`), which decides
`correct`.  The last line of standard output is the result's JSON.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import types  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Kernel and compiler caches at fixed paths inside the checkout, so that
# only a checkout's first run builds.
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = os.path.join(ROOT, ".portbench_cache", _sub)

from portbench import harness  # noqa: E402


def _log(*parts):
    print(*parts, flush=True)


def traced_context(drv, cell, tmp, wall_per_unit, sync):
    """Profile the cell's `profiled_units` traced units, with the raster
    kernels' launches recorded; returns the readers' context."""
    from straps_tpu_torch.render import cuda_raster as CR

    from portbench.trace import Trace

    recorders = {"packed": harness.Recorder(CR.packed_raster_kernel),
                 "faceid": harness.Recorder(CR.faceid_raster_kernel)}
    CR.packed_raster_kernel, CR.faceid_raster_kernel = recorders["packed"], recorders["faceid"]
    units = int(cell.traffic["profiled_units"])
    path = os.path.join(tmp, "trace.json")
    try:
        for r in recorders.values():
            r.active = True
        with harness.profiled(path):
            t = time.perf_counter()
            for _ in range(units):
                drv.traced_unit()
                sync()
            traced_s = time.perf_counter() - t
    finally:
        for r in recorders.values():
            r.active = False
        CR.packed_raster_kernel, CR.faceid_raster_kernel = (recorders["packed"].inner,
                                                             recorders["faceid"].inner)
    return types.SimpleNamespace(
        trace=Trace(path, units, traced_s), units=units, wall_per_unit_s=wall_per_unit,
        flops_per_unit=drv.flops_per_unit, raster={k: r.calls for k, r in recorders.items()},
        notes=[])


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t0: float = T0) -> int:
    import torch

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    tmp = tempfile.mkdtemp(prefix="portbench-", dir=os.environ.get("TMPDIR"))
    try:
        if cuda:
            _log("card:", harness.card_line())
        drv = cell.driver().Driver(cell, seed, device, tmp)
        setup_s = time.perf_counter() - t0
        for phase, s in drv.setup_log:
            _log(f"setup {phase}: {s:.4f} s")
        _log(f"setup_s {setup_s:.4f}")
        smi = harness.Smi(os.path.join(tmp, "smi.csv")) if cuda else None
        try:
            n, work, wall, walls = harness.window(drv.unit, seconds, sync)
        finally:
            if smi is not None:
                _log("beside the window:", smi.stop())
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        _log(f"window: {n} units, {work} {drv.work_name}, {wall:.6f} s; unit s median "
             f"{statistics.median(walls):.6f} min {min(walls):.6f} max {max(walls):.6f}; "
             f"memory peak {peak} bytes")
        dev_info = {"platform": "gpu" if cuda else "cpu",
                    "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                    "count": int(cell.workload["chips"]), "memory_peak_bytes": int(peak)}
        metrics, breakdown = {}, None
        if trace:
            ctx = traced_context(drv, cell, tmp, wall / n, sync)
            for m in cell.per_layer:
                value = cell.reader(m["name"])(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
            for note in ctx.notes:
                _log(note)
            dev_info["busy_s"] = ctx.trace.busy_s()
            dev_info["window_s"] = ctx.trace.window_s
            breakdown = {"device_ops": ctx.trace.device_ops(), "idle_gaps": ctx.trace.idle_gaps()}
        else:
            # The cell's one end-to-end metric besides `setup_s` is its rate.
            for m in cell.end_to_end:
                value = setup_s if m["name"] == "setup_s" else work / wall
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        t = time.perf_counter()
        numbers = drv.check()
        _log(f"check: {time.perf_counter() - t:.3f} s")
        found = harness.forbidden_modules()
        if found:
            print(f"modules that a run may not load: {found}", file=sys.stderr, flush=True)
            return 5
        for k, v in numbers.items():
            if k not in cell.limits:
                print(f"{k} {v!r} not compared (no limit holds; PERF.md)", file=sys.stderr)
        checks = {k: {"value": float(numbers[k]), "limit": float(limit)}
                  for k, limit in cell.limits.items()}
        correct = all(c["value"] <= c["limit"] for c in checks.values())
        for k, c in checks.items():
            print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
        print(harness.result_line(correct, n, 0, metrics, dev_info, checks, breakdown),
              flush=True)
        return 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    spec_path = os.path.join(os.getcwd(), "BENCHMARK.json")
    if not os.path.exists(spec_path):
        print("run from the root of a checkout: no BENCHMARK.json here", file=sys.stderr)
        return 2
    cell = harness.Cell(harness.load_json(spec_path), args.workload)
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); have "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        import straps_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the system under test is missing: {e}", file=sys.stderr)
        return 4
    return run_cell(cell, args.seed, args.seconds, bool(args.trace))


if __name__ == "__main__":
    sys.exit(main())
