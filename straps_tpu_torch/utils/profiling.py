"""Per-step wall-time accounting of the training loop and an on-demand
profiler trace (counterpart of `straps_tpu/utils/profiling.py`; its
compile cache is JAX tooling and is not ported)."""

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch

TRACE_FILE = "trace.json"


class StepTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def measure(self, name: str):
        t0 = time.perf_counter()
        yield
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def mean_ms(self, name: str) -> float:
        c = self.counts.get(name, 0)
        return (self.totals[name] / c * 1e3) if c else 0.0

    def summary(self) -> str:
        return " ".join(f"{k}={self.mean_ms(k):.1f}ms" for k in self.totals)

    def reset(self):
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[Optional[str]]:
    """`torch.profiler` over a block (host ops, and the card's kernels and
    copies where CUDA is available), written on exit as a Chrome trace
    `log_dir/trace.json`, whose path the context yields; a no-op yielding
    None when `log_dir` is None."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, TRACE_FILE)
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)
