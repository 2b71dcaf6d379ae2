"""The port's spans (`utils/profiling.py::span`) on the CPU: the shared
no-op while no profile records; under `torch.profiler`, the ranges of a
training step (`make_train_step`'s step on the plain rasteriser, with its
draws and host pull) and of a cached `predict_3d`, each holding its
children in order, as `user_annotation` events of the Chrome trace (what
the benchmark's span readers read); and `StepTimer.measure` timing as
before inside its span."""

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from straps_tpu_torch.config import PredictConfig, TrainConfig
from straps_tpu_torch.data.fixtures import write_synthetic_corpus
from straps_tpu_torch.predict import pipeline as TP
from straps_tpu_torch.smpl.assets import load_synthetic_assets
from straps_tpu_torch.train.loop import build_training, pull_to_host, train
from straps_tpu_torch.train.synthetic import draw_synthetic
from straps_tpu_torch.utils import profiling
from straps_tpu_torch.utils.profiling import StepTimer, span
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

IMG, B = 64, 2

SYNTH = ("straps.synth.body", "straps.synth.render", "straps.synth.proxy")
UPDATE = ("straps.update.forward", "straps.update.backward", "straps.update.adam",
          "straps.update.metrics")
PREDICT = ("straps.predict.load", "straps.predict.proxies", "straps.predict.regress",
           "straps.predict.write_npy", "straps.predict.render", "straps.predict.figures",
           "straps.predict.write_png")


def _spans(prof, tmp_path):
    """The `straps.*` user annotations of the profile's Chrome trace, as
    (name, start, end, [children]) trees in start order."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted(((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]), [])
                    for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and e["name"].startswith("straps.")), key=lambda s: (s[1], -s[2]))
    roots, stack = [], []
    for s in spans:
        while stack and s[1] >= stack[-1][2]:
            stack.pop()
        assert not stack or s[2] <= stack[-1][2], (s, stack[-1])   # nested, not overlapping
        (stack[-1][3] if stack else roots).append(s)
        stack.append(s)
    return roots


def _names(spans):
    return tuple(s[0] for s in spans)


def test_span_without_a_profile_is_the_shared_no_op(tmp_path):
    assert not torch.autograd._profiler_enabled()
    assert span("straps.a") is span("straps.b") is profiling._NO_SPAN
    with span("straps.a"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(2).sum()
    assert _spans(prof, tmp_path) == []
    assert span("straps.a") is profiling._NO_SPAN


def test_span_under_a_profile_is_a_record_function(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert span("straps.a") is not profiling._NO_SPAN
        with span("straps.a"):
            with span("straps.a.b"):
                torch.ones(2).sum()
    (a,) = _spans(prof, tmp_path)
    assert a[0] == "straps.a" and _names(a[3]) == ("straps.a.b",)


def test_train_step_spans(tmp_path):
    cfg = TrainConfig(img_wh=IMG, batch_size=B, focal_length=1250.0)
    cfg.train_path = cfg.val_path = write_synthetic_corpus(str(tmp_path / "c.npz"), n=B)
    cfg.model.compute_dtype = None
    _, assets, state, train_step, _ = build_training(cfg, load_synthetic_assets(device="cpu"),
                                                     device="cpu")
    rng = np.random.RandomState(0)
    pose = torch.tensor((rng.randn(B, 72) * 0.2).astype(np.float32))
    shape = torch.tensor((rng.randn(B, 10) * 0.5).astype(np.float32))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        draws = draw_synthetic(torch.Generator().manual_seed(0), B, assets.num_verts, cfg,
                               "cpu")
        loss, _, _ = pull_to_host(*train_step(state, draws, pose, shape))
    assert np.isfinite(loss)
    roots = _spans(prof, tmp_path)
    assert _names(roots) == ("straps.train.draws", "straps.train.synth", "straps.train.update",
                             "straps.train.pull")
    assert _names(roots[1][3]) == SYNTH
    assert _names(roots[2][3]) == UPDATE
    assert all(not s[3] for s in roots[1][3] + roots[2][3])


def test_epoch_loop_spans(tmp_path):
    """The loop's steps in `StepTimer`'s spans, as `run_train --profile-dir`
    traces them, and the checkpoint's save stall."""
    cfg = TrainConfig(img_wh=IMG, batch_size=B, focal_length=1250.0, num_epochs=1)
    cfg.train_path = cfg.val_path = write_synthetic_corpus(str(tmp_path / "c.npz"), n=B)
    cfg.model_save_path = str(tmp_path / "ckpt" / "model")
    cfg.log_path = str(tmp_path / "log.pkl")
    cfg.model.compute_dtype = None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train(cfg, assets=load_synthetic_assets(device="cpu"), verbose=False, device="cpu")
    roots = _spans(prof, tmp_path)
    assert _names(roots) == ("straps.train.train_step", "straps.train.val_step",
                             "straps.train.checkpoint")
    assert _names(roots[0][3]) == ("straps.train.draws", "straps.train.synth",
                                   "straps.train.update", "straps.train.pull")
    assert _names(roots[1][3]) == ("straps.train.synth", "straps.train.pull")


def test_cached_predict_spans(tmp_path):
    rng = np.random.RandomState(0)
    sils = np.zeros((2, 96, 96), np.float32)
    sils[:, 20:80, 30:65] = 1.0
    joints = rng.uniform([30, 20], [65, 80], (2, 17, 2)).astype(np.float32)
    TP.save_proxies(str(tmp_path / "proxies"), ["a", "b"], sils, joints)
    cfg = PredictConfig(input_dir=str(tmp_path / "proxies"), img_wh=IMG,
                        out_dir=str(tmp_path / "out"))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = TP.predict_3d(cfg, device="cpu")
    assert out["names"] == ["a", "b"]
    (root,) = _spans(prof, tmp_path)
    assert root[0] == "straps.predict"
    assert _names(root[3]) == PREDICT
    # No span inside a per-image loop: every child is a single range.
    assert all(not s[3] for s in root[3])


def test_step_timer_totals_counts_and_span(tmp_path):
    timer = StepTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.measure("train_step"):
            time.sleep(0.002)
    with timer.measure("train_step"):
        pass
    with timer.measure("val_step"):
        pass
    assert timer.counts == {"train_step": 2, "val_step": 1}
    assert timer.totals["train_step"] >= 0.002
    assert timer.mean_ms("train_step") == pytest.approx(timer.totals["train_step"] / 2 * 1e3)
    assert timer.summary().startswith("train_step=")
    assert _names(_spans(prof, tmp_path)) == ("straps.train.train_step",)
    timer.reset()
    assert timer.mean_ms("train_step") == 0.0
