"""What the `update_graph_pct.*` readers share: of the traced steps'
updates (the program's `straps.train.update` spans), the share that
replayed a CUDA graph (a `cudaGraphLaunch` inside the span), in %, with a
note of the program's counter (`train/step.py::UPDATE_GRAPH_STATS`: the
captures, replays and eager updates by reason since the process began).
A program without that counter reads None, as does a trace without the
update's spans."""

from portbench import spans

UPDATE = "straps.train.update"
GRAPH_LAUNCHES = ("cudaGraphLaunch", "cuGraphLaunch")


def update_graph_pct(ctx):
    try:
        from straps_tpu_torch.train.step import UPDATE_GRAPH_STATS
    except ImportError:
        return None
    s = spans.of(ctx)
    updates = [] if s is None else [(a, b) for n, a, b in s.spans if n == UPDATE]
    if not updates:
        return None
    launches = sorted(float(e["ts"]) for e in ctx.trace.runtime
                      if e.get("name") in GRAPH_LAUNCHES)
    replayed = sum(1 for a, b in updates if any(a <= t <= b for t in launches))
    eager = ", ".join(f"{k} {v}" for k, v in UPDATE_GRAPH_STATS["eager"].items())
    ctx.notes.append(f"update graphs: {replayed} of {len(updates)} traced updates replayed; "
                     f"the program's counter since it began: captures "
                     f"{UPDATE_GRAPH_STATS['captures']}, replays "
                     f"{UPDATE_GRAPH_STATS['replays']}, eager by reason: {eager}")
    return 100.0 * replayed / len(updates)
