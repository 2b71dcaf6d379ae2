"""The BatchNorm yardstick: the elements counted from the configuration
against forward hooks on the port's encoders, and the roofline reader on
hand-made traces (None where no BatchNorm kernel ran, as on a program
without them)."""

import json
import types

import pytest
import torch

from portbench import counters
from portbench.batchnorm import BYTES_PER_ELEMENT, batchnorm_elements
from portbench.tests.tiny import spec
from portbench.harness import Cell
from portbench.trace import Trace


@pytest.mark.parametrize("depth,want", [(18, 3_244_032), (50, 14_516_224)])
def test_elements_match_hooks_on_the_port_encoders(depth, want):
    from straps_tpu_torch.models import resnet

    assert batchnorm_elements(depth, 256) == want
    enc = resnet._depth(depth, 18).eval()
    seen = []
    for m in enc.modules():
        if isinstance(m, resnet.BatchNorm2d):
            m.register_forward_hook(lambda mod, i, o: seen.append(i[0].numel()))
    with torch.no_grad():
        enc(torch.zeros(1, 18, 256, 256))
    assert sum(seen) == want
    assert len(seen) == {18: 20, 50: 53}[depth]


def _ctx(tmp_path, names, units=2):
    ev = [{"ph": "X", "cat": "kernel", "name": n, "ts": 10 * i, "dur": 5} for i, n in
          enumerate(names)]
    ev.append({"ph": "X", "cat": "kernel", "name": "gemm", "ts": 1000, "dur": 50})
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return types.SimpleNamespace(trace=Trace(str(path), units, 1.0), units=units,
                                 wall_per_unit_s=1.0, flops_per_unit=0.0, raster={}, notes=[])


def test_reader_reads_none_without_the_kernels(tmp_path):
    ctx = _ctx(tmp_path, ["void at::native::elementwise_kernel<128, 2>(...)"])
    for name, workload in (("batchnorm_roofline.r18", "r18_train_b140"),
                           ("batchnorm_roofline.r50sil", "r50sil_train_b140")):
        assert Cell(spec(), workload).reader(name)(ctx) is None
    assert ctx.notes[0] == "batchnorm: no straps_batchnorm_ kernels in the trace"


def test_reader_is_least_time_over_the_kernels_time(tmp_path):
    names = [f"void straps_batchnorm_{k}<__nv_bfloat16, 8>(__nv_bfloat16 const*, int)"
             for k in ("stats", "normalize", "backward_sums", "backward_dx")] * 2
    ctx = _ctx(tmp_path, names)
    got = Cell(spec(), "r18_train_b140").reader("batchnorm_roofline.r18")(ctx)
    least = BYTES_PER_ELEMENT * 3_244_032 * 140 / counters.HBM_BYTES_S
    assert got == pytest.approx(100 * least / (8 * 5e-6 / 2))
    assert "4 launches a unit (straps_batchnorm_backward_dx 1, " in ctx.notes[0]
