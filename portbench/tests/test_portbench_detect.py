"""The photo path's cell on the CPU at a tiny size: the driver's set-up and
one unit against the reference, the control and the planted faults coming
out as not correct, the readers on a hand-made trace (the detector spans
read; a trace without them, as a program before them writes, reads None),
and the FLOP counter against hand counts of one layer of each kind."""

import contextlib
import io
import json
import os
import types

import pytest
import torch

from portbench import calibrate_detect, detector_counters as DC, harness, run
from portbench.tests.tiny import ROOT
from portbench.trace import Trace

WORKLOAD = "r18_predict_pointrend800"
SPAN_READERS = ("detect_device_ms", "detect_idle_ms", "proposals_device_ms",
                "subdivision_device_ms", "detector_load_ms", "decode_ms", "host_syncs_per_call")


def spec() -> dict:
    """The whole of `BENCHMARK.json` (`portbench/conftest.py` narrows
    `tiny.spec()` to the kinds `tiny.py` can shrink)."""
    return harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))


def tiny_cell() -> harness.Cell:
    """The cell with one PNG of 160x120 and one JPEG of 256x192, a 128 frame,
    detectors at 256², 64 proposals and 4 detections."""
    cell = harness.Cell(spec(), WORKLOAD)
    cell.traffic = dict(cell.traffic, png_photos=1, png_wh=[160, 120], jpeg_photos=1,
                        jpeg_wh=[256, 192])
    cfg = json.loads(json.dumps(cell.config))
    cfg.update(img_wh=64, detector_post_nms_topk=64, detector_max_detections=4)
    cfg["detectors"].update(image_frame=128, test_size=256)
    cell.config = cfg
    return cell


def _run(cell, seed=2**31 + 7):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.run_cell(cell, seed, 0.2, False, device="cpu")
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_setup_and_one_unit_are_correct():
    cell = tiny_cell()
    result = _run(cell)
    assert result["correct"] is True, result["checks"]
    assert set(result["metrics"]) == {"predict_images_per_s", "setup_s"}
    assert set(result["checks"]) == set(cell.limits)
    assert harness.forbidden_modules() == []


@pytest.mark.parametrize("fault", sorted(calibrate_detect.FAULTS))
def test_planted_fault_is_not_correct(fault):
    with calibrate_detect.planted(fault):
        assert _run(tiny_cell())["correct"] is False


def test_control_is_not_correct():
    """The reference with its detectors' backbone and FPN in bfloat16."""
    cell = tiny_cell()
    sides = dict(calibrate_detect.readings(cell, 5, True, "cpu"))
    assert any(sides["control"][k] > v for k, v in cell.limits.items()), sides["control"]
    assert all(sides["program"][k] <= v for k, v in cell.limits.items()), sides["program"]


def _span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": 1}


def _runtime(name, ts):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": 2, "tid": 1}


def _kernel(ts, dur):
    return {"ph": "X", "cat": "kernel", "name": "k", "ts": ts, "dur": dur}


PARENT = [_span("straps.predict", 0, 1000), _span("straps.predict.load", 0, 100),
          _span("straps.predict.proxies", 100, 800), _kernel(150, 100), _kernel(500, 300),
          _runtime("cudaStreamSynchronize", 600)]
DETECT = [_span("straps.predict.decode", 100, 50), _span("straps.detect.build", 150, 50),
          _span("straps.detect.keypoint", 200, 300), _span("straps.detect.proposals", 220, 100),
          _span("straps.detect.silhouette", 500, 350), _span("straps.detect.mask", 700, 100),
          _span("straps.detect.select", 850, 50)]


def _ctx(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return types.SimpleNamespace(trace=Trace(str(path), 1, 1.0), units=1, wall_per_unit_s=0.002,
                                 flops_per_unit=1e9, raster={}, notes=[])


def _read(name, ctx):
    return harness.Cell(spec(), WORKLOAD).reader(f"{name}.pointrend")(ctx)


@pytest.mark.parametrize("name", SPAN_READERS)
def test_span_readers_read_none_without_detector_spans(tmp_path, name):
    assert _read(name, _ctx(tmp_path, PARENT)) is None


def test_span_readers_read_the_detector_spans(tmp_path):
    ctx = _ctx(tmp_path, PARENT + DETECT)
    # Busy 150-250 and 500-800 us; keypoint 200-500, silhouette 500-850.
    assert _read("detect_device_ms", ctx) == pytest.approx((50 + 300) * 1e-3)
    assert _read("detect_idle_ms", ctx) == pytest.approx((250 + 50) * 1e-3)
    assert _read("proposals_device_ms", ctx) == pytest.approx(30 * 1e-3)
    assert _read("subdivision_device_ms", ctx) == pytest.approx(100 * 1e-3)
    assert _read("detector_load_ms", ctx) == pytest.approx(50 * 1e-3)
    assert _read("decode_ms", ctx) == pytest.approx(50 * 1e-3)
    assert _read("host_syncs_per_call", ctx) == 1.0
    assert _read("device_idle_pct", ctx) == pytest.approx(100 * (1 - 400e-6 / 0.002))
    assert _read("mfu", ctx) == pytest.approx(100 * 1e9 / 0.002 / 989e12)


@pytest.mark.parametrize("name, ms", [("regressor_load_ms", 100e-3), ("npy_write_ms", 40e-3)])
def test_predict_host_readers_read_the_parents_spans_too(tmp_path, name, ms):
    """The regressor's load and the npy writes are spans the program had
    before the detector spans: both sides of a comparison read them."""
    events = PARENT + [_span("straps.predict.write_npy", 900, 40)]
    assert _read(name, _ctx(tmp_path, events)) == pytest.approx(ms)
    assert _read(name, _ctx(tmp_path, events + DETECT)) == pytest.approx(ms)


def test_detector_counters_hold_hand_counts():
    assert DC.trunk_macs(800)["stem"] == 3 * 64 * 7 * 7 * 400 * 400
    assert DC.box_head_macs(1, 1) == 256 * 49 * 1024 + 1024 * 1024 + 1024 * 2 + 1024 * 4
    assert DC.keypoint_head_macs(1) == (256 * 512 * 9 * 196 + 7 * 512 * 512 * 9 * 196
                                        + 512 * 17 * 16 * 196)
    # detectron2 skips the 14² step (its 196 points are all re-predicted at 28²).
    assert DC.subdivision_points(5, 784) == 4 * 784
    coarse = 256 * 256 * 4 * 49 + 256 * 49 * 1024 + 1024 * 1024 + 1024 * 80 * 49
    point = 3 * (256 + 80) * 256 + (256 + 80) * 80
    assert DC.pointrend_head_macs(1, 80, 5, 784) == coarse + 4 * 784 * point
    assert DC.deconv_macs(512, 17, 4, 14) == 512 * 17 * 16 * 14 * 14


@pytest.mark.cuda
def test_control_is_not_correct_at_the_cells_size():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell's own size")
    cell = harness.Cell(spec(), WORKLOAD)
    sides = dict(calibrate_detect.readings(cell, 3, True, "cuda"))
    assert any(sides["control"][k] > v for k, v in cell.limits.items()), sides["control"]
    assert all(sides["program"][k] <= v for k, v in cell.limits.items()), sides["program"]
