"""The span readers (`portbench/spans.py`) on a hand-made Chrome trace:
idle time put down to the innermost span, a span nested in another of the
same name counted once, a sync outside every span not counted, and None
from a trace without the program's spans."""

import json
import types

import pytest

from portbench import harness, spans
from portbench.tests.tiny import spec
from portbench.trace import Trace

UNITS = 2


def _span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": 1}


def _runtime(name, ts):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": 2, "tid": 1}


def _kernel(ts, dur):
    return {"ph": "X", "cat": "kernel", "name": "k", "ts": ts, "dur": dur}


SPANS = [
    _span("straps.train.synth", 0, 100),
    _span("straps.synth.body", 0, 40),
    _span("straps.synth.render", 40, 60),
    _span("straps.train.update", 100, 200),
    _span("straps.update.forward", 100, 100),
    _span("straps.update.forward", 120, 30),      # nested in its namesake
    _span("straps.predict.write_npy", 400, 10),
    _span("straps.predict.write_png", 420, 30),
]
OTHER = [
    _kernel(10, 20), _kernel(50, 10), _kernel(150, 100),
    _runtime("cudaStreamSynchronize", 45),        # in render
    _runtime("cudaMemcpy", 110),                  # in forward
    _runtime("cudaMemcpyAsync", 60),              # not blocking
    _runtime("cudaDeviceSynchronize", 310),       # outside every span
    {"ph": "X", "cat": "cpu_op", "name": "aten::empty", "ts": 455, "dur": 5, "tid": 1},
]


def _ctx(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return types.SimpleNamespace(trace=Trace(str(path), UNITS, 1.0), units=UNITS,
                                 wall_per_unit_s=1.0, flops_per_unit=0.0, raster={}, notes=[])


def test_idle_goes_to_the_innermost_span(tmp_path):
    ctx = _ctx(tmp_path, SPANS + OTHER)
    s = spans.of(ctx)
    # Stretch 0-460 us, busy 130: idle 20 in body, 50 in render, 50 in
    # forward (both namesakes), 50 in update's own time, 400-460 split.
    assert dict(s.idle_split()) == {
        "straps.synth.body": 20.0, "straps.synth.render": 50.0,
        "straps.update.forward": 50.0, "straps.train.update": 50.0,
        "straps.predict.write_npy": 10.0, "straps.predict.write_png": 30.0, None: 120.0}
    assert sum(s.idle_split().values()) == pytest.approx(460.0 - 130.0)
    assert spans.span_idle_ms(ctx, "straps.train.synth") == pytest.approx(0.070 / UNITS)
    assert spans.span_idle_ms(ctx, "straps.train.update") == pytest.approx(0.100 / UNITS)
    assert spans.span_idle_ms(ctx, "straps.synth.body") == pytest.approx(0.020 / UNITS)
    (note,) = ctx.notes
    assert note.startswith("straps idle split") and "under no span 0.060 (36.4%)" in note


def test_a_nested_namesake_counts_once(tmp_path):
    ctx = _ctx(tmp_path, SPANS + OTHER)
    assert spans.span_host_ms(ctx, "straps.update.forward") == pytest.approx(0.100 / UNITS)
    assert spans.span_host_ms(ctx, "straps.predict.write_npy",
                              "straps.predict.write_png") == pytest.approx(0.040 / UNITS)


def test_syncs_outside_every_span_are_not_counted(tmp_path):
    ctx = _ctx(tmp_path, SPANS + OTHER)
    assert spans.host_syncs_per_unit(ctx) == pytest.approx(2 / UNITS)
    assert ctx.notes[-1] == ("host syncs a unit by innermost span: straps.synth.render 0.5, "
                             "straps.update.forward 0.5 (outside every span, not counted: 0.5)")


def _new_metrics():
    return [(w, m["name"]) for m in spec()["per_layer"] for w in m["workloads"]
            if m["name"].split(".")[0] in ("synth_idle_ms", "update_idle_ms",
                                             "host_syncs_per_step", "predict_load_ms",
                                             "predict_figures_ms", "predict_write_ms")]


def test_the_nine_readers_read_the_spans(tmp_path):
    found = _new_metrics()
    assert len(found) == 9
    ctx = _ctx(tmp_path, SPANS + OTHER + [_span("straps.predict.load", 460, 40),
                                          _span("straps.predict.figures", 500, 80)])
    for workload, name in found:
        value = harness.Cell(spec(), workload).reader(name)(ctx)
        assert value is not None and value >= 0, name
    reader = harness.Cell(spec(), "r18_predict_cached16").reader
    assert reader("predict_figures_ms.predict")(ctx) == pytest.approx(0.080 / UNITS)
    assert reader("predict_load_ms.predict")(ctx) == pytest.approx(0.040 / UNITS)
    assert reader("predict_write_ms.predict")(ctx) == pytest.approx(0.040 / UNITS)


def test_no_program_spans_read_none(tmp_path):
    """The program before its spans: the benchmark's own ranges only."""
    ctx = _ctx(tmp_path, [{**_span("portbench.synth", 0, 100)},
                          {**_span("portbench.update", 100, 200)}] + OTHER)
    for workload, name in _new_metrics():
        assert harness.Cell(spec(), workload).reader(name)(ctx) is None, name
    assert ctx.notes == ["straps spans: none in the trace"]
