"""Every cell driven on the CPU at a tiny size: set-up, the window, the
comparison with the reference; the reference against the port; the
control and the planted faults coming out as not correct; no forbidden
module loaded; and, on a card, the control at the cell's own size."""

import ast
import contextlib
import io
import json
import os

import pytest
import torch

from portbench import calibrate, compare, harness, run
from portbench.tests.tiny import ROOT, spec, tiny_cell

WORKLOADS = [w["name"] for w in spec()["workloads"]]
PB = os.path.join(ROOT, "portbench")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(PB, sub)):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_source_imports_jax_or_the_jax_package():
    found = {(p, m) for p in _sources() for m in _imports(p) if m in harness.FORBIDDEN}
    assert not found


def test_reference_imports_nothing_of_the_program():
    found = {(p, m) for p in _sources("reference") for m in _imports(p)
             if m not in ("torch", "numpy", "math", "portbench")}
    assert not found


def _run(cell, seed=2**31 + 7):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.run_cell(cell, seed, 0.2, False, device="cpu")
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("workload", WORKLOADS)
def test_dry_run_prints_a_result_and_loads_no_jax(workload):
    result = _run(tiny_cell(workload))
    assert set(result) >= {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert list(result)[-1] == "checks"
    cell = tiny_cell(workload)
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert set(result["checks"]) == set(cell.limits)
    assert harness.forbidden_modules() == []


@pytest.mark.parametrize("workload", WORKLOADS)
def test_reference_follows_the_float32_program(workload):
    """With the encoder in float32 the program and the reference agree to
    rounding, so what the bfloat16 cells read is the encoder's precision."""
    cell = tiny_cell(workload)
    cell.config["model"]["compute_dtype"] = None
    numbers = dict(calibrate.readings(cell, 11, False, "cpu"))["program"]
    tight = {"loss1_gap": 1e-5, "frames_gap": 1e-4, "frames_median_gap": 1e-4,
             "grad_median_gap": 1e-4, "change_gap": 1e-2, "proxy_mismatch": 0.0,
             "joints_gap_px": 1e-4, "verts_gap_m": 1e-5, "cam_gap": 1e-5, "params_gap": 1e-5,
             "render_mismatch": 0.0, "tasks1_gap": 1e-5, "tasks1_median_gap": 1e-5,
             "tasks_gap": 1e-4}
    # Distances in metres: a micrometre.
    assert all(v <= tight.get(k, 1e-6) for k, v in numbers.items()), numbers


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(workload):
    """The reference in the program's place, its encoder on float8 inputs
    and weights (TF32 has no CPU form), fails one of the cell's limits."""
    cell = tiny_cell(workload)
    sides = dict(calibrate.readings(cell, 5, True, "cpu"))
    assert any(sides["control"][k] > v for k, v in cell.limits.items()), sides["control"]


def _alter_frames(orig):
    def pull(loss, task_losses, per_frame):
        value, tasks, frames = orig(loss, task_losses, per_frame)
        return value, tasks, {k: v * 2.0 for k, v in frames.items()}
    return pull


def _half_loss(orig):
    """The loss over the first half of the batch; the forward pass and the
    per-frame metrics still cover all of it."""
    def loss(log_vars, labels, outputs, img_wh, mesh=None):
        n = labels["verts"].shape[0] // 2
        return orig(log_vars, {k: v[:n] for k, v in labels.items()},
                    {k: v[:n] for k, v in outputs.items()}, img_wh, mesh)
    return loss


def _alter_batch(orig):
    """The step's synthetic batch with its 2D joint targets moved a pixel."""
    def build(*a, **k):
        b = orig(*a, **k)
        return b._replace(target_joints2d_coco=b.target_joints2d_coco + 1.0)
    return build


def _predict_wrapper(change):
    def make(orig):
        def build(*a, **k):
            predict = orig(*a, **k)

            def wrapped(proxies):
                return change(predict, proxies)
            return wrapped
        return build
    return make


def _half_predict(predict, proxies):
    n = max(1, proxies.shape[0] // 2)
    out = predict(proxies[:n])
    return {k: torch.cat([v, v[:proxies.shape[0] - n]]) for k, v in out.items()}


def _alter_predict(predict, proxies):
    out = dict(predict(proxies))
    out["verts"] = out["verts"] + 0.01
    return out


FAULTS = {
    "r18_train_b140": [
        ("state unchanged", "torch.optim.Adam", "step", lambda orig: lambda self, *a, **k: None),
        ("half of the batch", "straps_tpu_torch.train.step", "multi_task_loss", _half_loss),
        ("answer altered", "straps_tpu_torch.train.loop", "pull_to_host", _alter_frames),
        ("synthetic batch altered", "straps_tpu_torch.train.step", "generate_synthetic_batch",
         _alter_batch),
    ],
    "r18_predict_cached16": [
        ("half of the batch", "straps_tpu_torch.predict.pipeline", "make_predict_fn",
         _predict_wrapper(_half_predict)),
        ("answer altered", "straps_tpu_torch.predict.pipeline", "make_predict_fn",
         _predict_wrapper(_alter_predict)),
    ],
}
FAULTS["r50sil_train_b140"] = FAULTS["r18_train_b140"]


def _target(path):
    import importlib

    parts = path.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except ImportError:
            continue
        for p in parts[i:]:
            obj = getattr(obj, p)
        return obj
    raise ImportError(path)


@pytest.mark.parametrize("workload,fault", [(w, f[0]) for w in WORKLOADS for f in FAULTS[w]])
def test_planted_fault_is_not_correct(workload, fault, monkeypatch):
    _, where, name, make = next(f for f in FAULTS[workload] if f[0] == fault)
    target = _target(where)
    monkeypatch.setattr(target, name, make(getattr(target, name)))
    assert _run(tiny_cell(workload))["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct_at_the_cells_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell's own size")
    cell = harness.Cell(spec(), workload)
    sides = dict(calibrate.readings(cell, 3, True, "cuda"))
    assert any(sides["control"][k] > v for k, v in cell.limits.items()), sides["control"]
    assert all(sides["program"][k] <= v for k, v in cell.limits.items()), sides["program"]


def test_gap_of_a_missing_answer_fails():
    assert compare._gap([1.0, 2.0], [1.0]) == compare.MISSING
