"""The `synth_graph_pct.*` readers on a hand-made Chrome trace: 100 where
every traced synthetic batch replays a graph, the share where one ran
eagerly, a note of the program's counter, and None from a program
without the counter or a trace without the batch's spans."""

import json
import sys
import types

import pytest

from portbench import harness
from portbench.tests.tiny import spec
from portbench.trace import Trace

UNITS = 3
CELLS = {"synth_graph_pct.r18": "r18_train_b140",
         "synth_graph_pct.r50sil": "r50sil_train_b140"}


def _event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 1}


def _steps(graphed):
    """A synthetic batch span and an update span a step, 100 us apart; a
    `cudaGraphLaunch` inside the batches marked True, kernel launches in
    the others, and a graph launch inside every update."""
    events = []
    for i, g in enumerate(graphed):
        t = 100.0 * i
        events.append(_event("user_annotation", "straps.train.synth", t, 40))
        events.append(_event("cuda_runtime", "cudaGraphLaunch" if g else "cudaLaunchKernel",
                             t + 10, 5))
        events.append(_event("kernel", "k", t + 20, 15))
        events.append(_event("user_annotation", "straps.train.update", t + 50, 40))
        events.append(_event("cuda_runtime", "cudaGraphLaunch", t + 60, 5))
        events.append(_event("kernel", "k", t + 70, 15))
    return events


def _ctx(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return types.SimpleNamespace(trace=Trace(str(path), UNITS, 1.0), units=UNITS,
                                 wall_per_unit_s=1.0, flops_per_unit=0.0, raster={}, notes=[])


def _read(metric, ctx):
    return harness.Cell(spec(), CELLS[metric]).reader(metric)(ctx)


@pytest.mark.parametrize("metric", sorted(CELLS))
def test_every_traced_batch_replayed_reads_100(tmp_path, metric):
    ctx = _ctx(tmp_path, _steps([True] * UNITS))
    assert _read(metric, ctx) == 100.0
    assert any(n.startswith("synthetic batch graphs: 3 of 3 traced batches replayed; the "
                            "program's counter since it began: captures")
               and "first_of_key" in n for n in ctx.notes)


@pytest.mark.parametrize("metric", sorted(CELLS))
def test_an_eager_batch_lowers_the_share(tmp_path, metric):
    """The update's graph launch beside an eager batch does not count."""
    ctx = _ctx(tmp_path, _steps([False, True, True]))
    assert _read(metric, ctx) == pytest.approx(200.0 / 3)


@pytest.mark.parametrize("metric", sorted(CELLS))
def test_no_counter_or_no_batch_span_reads_none(tmp_path, metric, monkeypatch):
    ctx = _ctx(tmp_path, [e for e in _steps([True] * UNITS)
                          if e["name"] != "straps.train.synth"])
    assert _read(metric, ctx) is None
    # A program before the counter: its train/synthetic.py has no SYNTH_GRAPH_STATS.
    monkeypatch.setitem(sys.modules, "straps_tpu_torch.train.synthetic",
                        types.ModuleType("straps_tpu_torch.train.synthetic"))
    assert _read(metric, _ctx(tmp_path, _steps([True] * UNITS))) is None
