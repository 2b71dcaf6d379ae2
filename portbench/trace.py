"""Reduction of a `torch.profiler` trace to what the per-layer metrics
read: device intervals and their union, kernels by name, launches, the
device time of the kernels launched inside each of the benchmark's ranges,
and the longest idle gaps of the device by what the host was doing.

The trace is read from the Chrome-trace JSON the profiler exports, whose
event categories are stable across PyTorch versions.
"""

import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_NAMES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaLaunchCooperativeKernel", "cudaGraphLaunch", "cuGraphLaunch")
RANGE_PREFIX = "portbench."


class Trace:
    """The events of one profiled stretch of `units` units."""

    def __init__(self, path: str, units: int, window_s: float):
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        self.units, self.window_s = units, window_s
        self.device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        self.runtime = [e for e in events if e.get("ph") == "X"
                        and e.get("cat") in ("cuda_runtime", "cuda_driver")]
        self.host = [e for e in events if e.get("ph") == "X"
                     and e.get("cat") in ("cpu_op", "user_annotation", "python_function")]
        self.ranges = [e for e in self.host if e.get("cat") == "user_annotation"
                       and str(e.get("name", "")).startswith(RANGE_PREFIX)]

    def busy_intervals(self):
        """The union of the device's kernel, copy and memset intervals, in us."""
        spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                       for e in self.device)
        merged = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def launches(self) -> int:
        return sum(1 for e in self.runtime if e.get("name") in LAUNCH_NAMES)

    def kernels(self, *parts):
        """Kernel events whose name holds every one of `parts`."""
        return [e for e in self.device if e.get("cat") == "kernel"
                and all(p in e.get("name", "") for p in parts)]

    def device_ops(self, top: int = 10):
        tot = defaultdict(float)
        for e in self.device:
            tot[e.get("name", "?")] += float(e.get("dur", 0)) * 1e-6
        return sorted(([k, v] for k, v in tot.items()), key=lambda kv: -kv[1])[:top]

    def range_device_s(self, name: str) -> float:
        """Device seconds of the kernels, copies and memsets launched inside
        the benchmark's ranges called `name`."""
        spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                 for e in self.ranges if e.get("name") == RANGE_PREFIX + name]
        corr = set()
        for e in self.runtime:
            # Any thread: the backward pass launches from autograd's own.
            ts = float(e["ts"])
            if any(a <= ts <= b for a, b in spans):
                c = e.get("args", {}).get("correlation")
                if c is not None:
                    corr.add(c)
        return sum(float(e.get("dur", 0)) for e in self.device
                   if e.get("args", {}).get("correlation") in corr) * 1e-6

    def idle_gaps(self, top: int = 10):
        """The longest gaps between device intervals, each named by the host
        operation that overlaps it most (the shorter on a tie), the
        benchmark's own ranges only where no operation overlaps it."""
        busy = self.busy_intervals()
        gaps = [(b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
        gaps.sort(reverse=True)
        out = []
        for length, a, b in gaps[:top]:
            best, best_key = "host", (0, 0.0, 0.0)
            for e in self.host:
                s, dur = float(e["ts"]), float(e.get("dur", 0))
                ov = min(b, s + dur) - max(a, s)
                own = str(e.get("name", "")).startswith(RANGE_PREFIX)
                key = (0 if own else 1, ov, -dur)
                if ov > 0 and key > best_key:
                    best, best_key = e.get("name", "host"), key
            out.append([best, length * 1e-6])
        return out
