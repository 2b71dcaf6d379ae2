"""Per-step wall-time accounting of the training loop, spans on the
profiler's clock and an on-demand profiler trace (counterpart of
`straps_tpu/utils/profiling.py`; its compile cache is JAX tooling and is
not ported)."""

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch

TRACE_FILE = "trace.json"

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A named range of host time on the profiler's clock.

    While a `torch.profiler` profile records, this is
    `torch.profiler.record_function(name)`: the range lands in the Chrome
    trace as a `user_annotation` event, on the same timeline as the card's
    kernels and copies.  Otherwise it is one shared no-op context manager,
    so a span costs only the check whether a profile records.  A span's
    parent is the span that encloses it on the same thread: the port runs
    its units (steps, calls) one after another, so no request id is needed.
    Spans are named `straps.<layer>[.<part>]` and are opened around whole
    stages, never inside a per-image, per-face or per-row loop."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


class StepTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def measure(self, name: str):
        """Time the block on the host clock, in the span `straps.train.<name>`."""
        with span(f"straps.train.{name}"):
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
