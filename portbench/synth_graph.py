"""What the `synth_graph_pct.*` readers share: of the traced steps'
synthetic batches (the program's `straps.train.synth` spans), the share
that replayed a CUDA graph (a `cudaGraphLaunch` inside the span), in %,
with a note of the program's counter
(`train/synthetic.py::SYNTH_GRAPH_STATS`: the captures, replays and eager
calls by reason since the process began).  A program without that counter
reads None, as does a trace without the batch's spans."""

from portbench import spans
from portbench.update_graph import GRAPH_LAUNCHES

SYNTH = "straps.train.synth"


def synth_graph_pct(ctx):
    try:
        from straps_tpu_torch.train.synthetic import SYNTH_GRAPH_STATS
    except ImportError:
        return None
    s = spans.of(ctx)
    batches = [] if s is None else [(a, b) for n, a, b in s.spans if n == SYNTH]
    if not batches:
        return None
    launches = sorted(float(e["ts"]) for e in ctx.trace.runtime
                      if e.get("name") in GRAPH_LAUNCHES)
    replayed = sum(1 for a, b in batches if any(a <= t <= b for t in launches))
    eager = ", ".join(f"{k} {v}" for k, v in SYNTH_GRAPH_STATS["eager"].items())
    ctx.notes.append(f"synthetic batch graphs: {replayed} of {len(batches)} traced batches "
                     f"replayed; the program's counter since it began: captures "
                     f"{SYNTH_GRAPH_STATS['captures']}, replays "
                     f"{SYNTH_GRAPH_STATS['replays']}, eager by reason: {eager}")
    return 100.0 * replayed / len(batches)
