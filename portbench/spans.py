"""What the span readers share: the program's own spans (`straps.*`
`user_annotation` events, opened by `straps_tpu_torch/utils/profiling.py::
span`) laid against the device's busy intervals and the CUDA runtime's
blocking calls, all on the profiler's one clock.

A span's time is the union of its intervals, so a span nested in another
of the same name counts once.  A trace without `straps.*` spans (a program
before them) reads None.  Device idle time is the complement of the union
of kernel, copy and memset intervals (`Trace.busy_intervals`); the traced
stretch runs from the trace's first host, runtime or device event to its
last.  The first reader of a cell adds one note: the stretch's idle time
split by the innermost span over it, and the part under no span.
"""

import bisect
from collections import defaultdict

PREFIX = "straps."
SYNC_NAMES = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")


def union(intervals):
    """Sorted, merged [start, end] intervals."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


class Busy:
    """The device's busy time inside any host interval, from the merged
    busy intervals and their running sums."""

    def __init__(self, merged):
        self.starts = [a for a, _ in merged]
        self.ends = [b for _, b in merged]
        self.sums = [0.0]
        for a, b in merged:
            self.sums.append(self.sums[-1] + b - a)

    def within(self, a: float, b: float) -> float:
        i = bisect.bisect_right(self.ends, a)     # first interval ending after a
        j = bisect.bisect_left(self.starts, b)    # first interval starting at or after b
        if i >= j:
            return 0.0
        return (self.sums[j] - self.sums[i] - max(0.0, a - self.starts[i])
                - max(0.0, self.ends[j - 1] - b))

    def idle(self, a: float, b: float) -> float:
        return (b - a) - self.within(a, b)


class Spans:
    """The `straps.*` spans of one traced stretch, in us."""

    def __init__(self, trace):
        self.spans = [(str(e["name"]), float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                      for e in trace.host if e.get("cat") == "user_annotation"
                      and str(e.get("name", "")).startswith(PREFIX)]
        self.busy = Busy(trace.busy_intervals())
        events = trace.host + trace.runtime + trace.device
        self.lo = min((float(e["ts"]) for e in events), default=0.0)
        self.hi = max((float(e["ts"]) + float(e.get("dur", 0)) for e in events), default=0.0)
        self.syncs = [float(e["ts"]) for e in trace.runtime if e.get("name") in SYNC_NAMES]

    def named(self, *names):
        """The union of the intervals of the spans called any of `names`."""
        return union([[a, b] for n, a, b in self.spans if n in names])

    def innermost(self, a: float, b: float):
        """The innermost span holding all of [a, b]: of those holding it,
        the latest to start (the shortest on a tie); None under no span."""
        best = None
        for n, s, e in self.spans:
            if s <= a and b <= e and (best is None or (s, -e) > (best[1], -best[2])):
                best = (n, s, e)
        return None if best is None else best[0]

    def idle_split(self):
        """{innermost span or None: device-idle us} over the stretch."""
        cuts = sorted({self.lo, self.hi} | {t for _, s, e in self.spans for t in (s, e)
                                            if self.lo < t < self.hi})
        out = defaultdict(float)
        for a, b in zip(cuts, cuts[1:]):
            idle = self.busy.idle(a, b)
            if idle > 0:
                out[self.innermost(a, b)] += idle
        return out


def of(ctx):
    """The cell's `Spans`, made once and kept on the readers' context; None
    where the trace holds no `straps.*` span.  The first call adds the
    idle-split note."""
    if not hasattr(ctx, "straps_spans"):
        s = Spans(ctx.trace)
        ctx.straps_spans = s if s.spans else None
        if s.spans:
            ctx.notes.append(_idle_note(s, ctx.units))
        else:
            ctx.notes.append("straps spans: none in the trace")
    return ctx.straps_spans


def _idle_note(s: Spans, units: int) -> str:
    split = s.idle_split()
    total = sum(split.values())
    parts = sorted(split.items(), key=lambda kv: -kv[1])
    return (f"straps idle split, ms a unit (traced stretch {(s.hi - s.lo) * 1e-3 / units:.3f}, "
            f"device idle {total * 1e-3 / units:.3f}), by innermost span: "
            + ", ".join(f"{n or 'under no span'} {v * 1e-3 / units:.3f} "
                        f"({100.0 * v / total:.1f}%)" for n, v in parts))


def span_idle_ms(ctx, name: str):
    """Device-idle ms a unit inside the spans called `name`."""
    s = of(ctx)
    if s is None:
        return None
    u = s.named(name)
    if not u:
        return None
    return sum(s.busy.idle(a, b) for a, b in u) * 1e-3 / ctx.units


def span_host_ms(ctx, *names: str):
    """Host ms a unit inside the spans called any of `names`."""
    s = of(ctx)
    if s is None:
        return None
    u = s.named(*names)
    if not u:
        return None
    return sum(b - a for a, b in u) * 1e-3 / ctx.units


def host_syncs_per_unit(ctx):
    """Blocking sync calls a unit whose host call starts inside a `straps.*`
    span; adds a note of the calls by innermost span.  The harness's own
    sync between units lies outside every span and is not counted."""
    s = of(ctx)
    if s is None:
        return None
    by_span = defaultdict(int)
    for t in s.syncs:
        by_span[s.innermost(t, t)] += 1
    outside = by_span.pop(None, 0)
    n = sum(by_span.values())
    inside = ", ".join(f"{k} {v / ctx.units:g}" for k, v in sorted(by_span.items()))
    ctx.notes.append(f"host syncs a unit by innermost span: {inside or 'none'} "
                     f"(outside every span, not counted: {outside / ctx.units:g})")
    return n / ctx.units
