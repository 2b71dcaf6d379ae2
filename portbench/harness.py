"""The benchmark's general machinery: `BENCHMARK.json` and the files it
names, the measured window, the traced stretch, the per-layer readers, the
chip's clocks and power beside the window, and the result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file found by its name:
`configs/<config>.json`, `traffic/<traffic>.json` (whose `kind` picks the
driver `drivers/<kind>.py`), `limits/<workload>.json` and
`layer_metrics/<metric>.py`.
"""

import contextlib
import importlib
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "straps_tpu")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that a run may not hold, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of `BENCHMARK.json` with its configuration, traffic mix,
    limits and metrics."""

    def __init__(self, spec: dict, workload: str, root: str = HERE):
        cells = {w["name"]: w for w in spec["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; have {sorted(cells)}")
        self.workload = cells[workload]
        self.name = workload
        self.config_entry = {c["name"]: c for c in spec["configs"]}[self.workload["config"]]
        self.config = load_json(os.path.join(os.path.dirname(root), self.config_entry["file"]))
        self.traffic = load_json(os.path.join(root, "traffic", self.workload["traffic"] + ".json"))
        self.limits = load_json(os.path.join(root, "limits", workload + ".json"))

        def mine(metrics):
            return [m for m in metrics if workload in m.get("workloads", [workload])]

        self.end_to_end = mine(spec["end_to_end"])
        self.per_layer = mine(spec["per_layer"])
        self.root = root

    def driver(self):
        return importlib.import_module(f"portbench.drivers.{self.traffic['kind']}")

    def reader(self, metric: str):
        path = os.path.join(self.root, "layer_metrics", metric + ".py")
        spec = importlib.util.spec_from_file_location(f"portbench_layer_{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def window(unit, seconds: float, sync=None):
    """Run whole units until `seconds` have passed; the window ends with
    the last unit that started before then.  Returns (units, work, wall s,
    per-unit walls)."""
    walls, work = [], 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        s = time.perf_counter()
        work += unit()
        if sync is not None:
            sync()
        walls.append(time.perf_counter() - s)
    return len(walls), work, time.perf_counter() - t0, walls


class Smi:
    """`nvidia-smi` sampling the card's SM clock, power and temperature
    once a second beside the window, into a file of the run's own."""

    QUERY = "clocks.sm,power.draw,power.limit,temperature.gpu"

    def __init__(self, path: str):
        self.path, self.proc = path, None
        exe = shutil.which("nvidia-smi")
        if exe is not None:
            self.out = open(path, "w")
            self.proc = subprocess.Popen([exe, f"--query-gpu={self.QUERY}",
                                          "--format=csv,noheader,nounits", "-lms", "1000"],
                                         stdout=self.out, stderr=subprocess.DEVNULL)

    def stop(self) -> str:
        if self.proc is None:
            return "nvidia-smi not found"
        self.proc.terminate()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.out.close()
        rows = []
        with open(self.path) as f:
            for line in f:
                parts = [p.strip() for p in line.split(",")]
                try:
                    rows.append([float(p) for p in parts])
                except ValueError:
                    continue
        if not rows:
            return "no nvidia-smi samples"
        cols = list(zip(*rows))
        return (f"{len(rows)} samples: sm clock MHz median {statistics.median(cols[0])} "
                f"min {min(cols[0])}; power W median {statistics.median(cols[1])} "
                f"max {max(cols[1])}; power limit W {cols[2][0]}; "
                f"temperature C max {max(cols[3])}")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "nvidia-smi not found"
    out = subprocess.run([exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30)
    return out.stdout.strip().replace("\n", " | ")


class Recorder:
    """Stands in for a kernel object of the program and keeps each launch's
    arguments, while `active`, for the roofline readers."""

    def __init__(self, inner):
        self.inner, self.calls, self.active = inner, [], False

    def __call__(self, *args):
        if self.active:
            self.calls.append(args)
        return self.inner(*args)

    def __getattr__(self, name):
        return getattr(self.inner, name)


@contextlib.contextmanager
def profiled(path: str):
    """`torch.profiler` over CPU and CUDA activity, exported as a Chrome
    trace to `path` on exit."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)


def result_line(correct, attempted, failed, metrics, device, checks, breakdown=None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)
