"""What the photo path's span readers share: the detector spans
(`straps.detect.*`, `straps.predict.decode`) of the traced call, laid
against the device's busy intervals and the CUDA runtime's blocking calls
(`spans.Spans`).  A trace without `straps.detect.*` spans (a program
before them) reads None in every reader."""

from portbench import spans

DETECT = "straps.detect."


def detect_spans(ctx):
    """The cell's `spans.Spans` where the trace holds a `straps.detect.*`
    span, else None."""
    s = spans.of(ctx)
    if s is None or not any(n.startswith(DETECT) for n, _, _ in s.spans):
        return None
    return s


def busy_ms(ctx, *names):
    """Device-busy ms a unit inside the spans called any of `names`."""
    s = detect_spans(ctx)
    u = [] if s is None else s.named(*names)
    if not u:
        return None
    return sum(s.busy.within(a, b) for a, b in u) * 1e-3 / ctx.units


def idle_ms(ctx, *names):
    """Device-idle ms a unit inside the spans called any of `names`."""
    s = detect_spans(ctx)
    u = [] if s is None else s.named(*names)
    if not u:
        return None
    return sum(s.busy.idle(a, b) for a, b in u) * 1e-3 / ctx.units


def detect_syncs(ctx):
    """Blocking sync calls a unit whose innermost `straps.*` span is a
    `straps.detect.*` one; notes them by span, with the NMS calls and
    fixpoint rounds of the port's counter over the traced units."""
    s = detect_spans(ctx)
    if s is None:
        return None
    by_span = {}
    for t in s.syncs:
        name = s.innermost(t, t)
        if name is not None and name.startswith(DETECT):
            by_span[name] = by_span.get(name, 0) + 1
    n = sum(by_span.values())
    note = ", ".join(f"{k} {v / ctx.units:g}" for k, v in sorted(by_span.items()))
    ctx.notes.append(f"detector host syncs a call by innermost span: {note or 'none'}")
    cover = sum(b - a for a, b in spans.union([[a, b] for name, a, b in s.spans
                                                 if name.startswith(DETECT)]))
    ctx.notes.append(f"straps.detect.* spans: {cover * 1e-3 / ctx.units:.3f} ms a call, "
                     f"{100.0 * cover / max(s.hi - s.lo, 1e-9):.1f}% of the traced stretch")
    try:
        from straps_tpu_torch.perception.ops import NMS_STATS
    except ImportError:
        NMS_STATS = {}
    if "calls" in NMS_STATS:
        ctx.notes.append(f"nms_fixed a call: {NMS_STATS['calls'] / ctx.units:g} calls, "
                         f"{NMS_STATS['blocks'] / ctx.units:g} blocks, "
                         f"{NMS_STATS['syncs'] / ctx.units:g} fixpoint rounds (host syncs)")
    return n / ctx.units
