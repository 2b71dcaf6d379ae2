"""The trace reduction and the readers on a hand-made Chrome trace."""

import json
import types

import pytest

from portbench import readers
from portbench.trace import Trace


def _trace(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "portbench.synth", "ts": 0, "dur": 100,
         "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "portbench.update", "ts": 100, "dur": 300,
         "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 10, "dur": 5,
         "tid": 1, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 120, "dur": 5,
         "tid": 2, "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 130, "dur": 5,
         "tid": 1, "args": {"correlation": 3}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 200, "dur": 150, "tid": 1},
        {"ph": "X", "cat": "kernel", "name": "void span_raster_kernel<PackedKeys>(...)",
         "ts": 20, "dur": 40, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 140, "dur": 50,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 180, "dur": 20,
         "args": {"correlation": 3}},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return Trace(str(path), units=1, window_s=400e-6)


def test_union_ranges_launches_and_gaps(tmp_path):
    t = _trace(tmp_path)
    assert t.busy_intervals() == [[20.0, 60.0], [140.0, 200.0]]
    assert t.busy_s() == pytest.approx(100e-6)
    assert t.launches() == 2
    assert t.range_device_s("synth") == pytest.approx(40e-6)
    assert t.range_device_s("update") == pytest.approx(70e-6)
    # Every launch falls in one range: the ranges split all device time.
    assert t.range_device_s("synth") + t.range_device_s("update") == pytest.approx(110e-6)
    assert t.idle_gaps() == [["portbench.synth", pytest.approx(80e-6)]]
    assert t.device_ops()[0] == ["gemm", pytest.approx(50e-6)]


def test_readers(tmp_path):
    ctx = types.SimpleNamespace(trace=_trace(tmp_path), units=1, wall_per_unit_s=500e-6,
                                flops_per_unit=989e12 * 500e-6 * 0.25, raster={}, notes=[])
    assert readers.device_idle_pct(ctx) == pytest.approx(80.0)
    assert readers.mfu_pct(ctx) == pytest.approx(25.0)
    assert readers.launches_per_unit(ctx) == 2
    assert readers.range_device_ms(ctx, "synth") == pytest.approx(0.04)
    # No recorded launches: the roofline reader finds nothing to read.
    assert readers.raster_roofline_pct(ctx, "packed") is None
