"""Per-step wall-time accounting of the training loop (the `StepTimer` of
`straps_tpu/utils/profiling.py`; its trace capture and compile cache are
JAX tooling and are not ported)."""

import contextlib
import time
from collections import defaultdict
from typing import Dict


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
