"""The port's CLIs over two gloo ranks on the CPU, and the data-parallel
dry run (`python -m straps_tpu_torch.parallel.dryrun 2`).

`run_train data_parallel_devices=2 --device cpu` trains one epoch (64x64,
B=8, float32 encoder: 8 train and 4 validation steps) over two ranks: rank
0 writes the one checkpoint and the history, which is within 1e-4 of the
one-process run's.  At learning rate 0: Adam moves every parameter by
about ±lr whatever its gradient's size, so the reduction-order noise of
near-zero gradients moves two runs apart by up to 2·lr a step, as the JAX
suite's one-vs-eight-device test avoids with SGD;
`tests/test_torch_parallel_train.py` holds the step itself, Adam
included.  A resume over two ranks continues it at the default learning
rate: the parameters move, and both ranks end bitwise equal.  `run_eval --data-parallel-devices 2` prints the
one-process metrics.  Asking for more cards than are visible raises
before any file is written.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from straps_tpu_torch.cli import run_eval, run_train
from straps_tpu_torch.config import TrainConfig
from straps_tpu_torch.parallel import dryrun
from straps_tpu_torch.utils.checkpoints import load_checkpoint
from test_torch_eval import _dataset, checkpoint  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TRAIN_ARGS = ["--synthetic-data", "--device", "cpu", "img_wh=64", "batch_size=8",
              "focal_length=1250.0", "num_epochs=1", "model.compute_dtype=None"]


def _train(workdir, monkeypatch, *extra):
    os.makedirs(workdir)
    monkeypatch.chdir(workdir)
    run_train.main(TRAIN_ARGS + ["lr=0.0"] + list(extra))
    with open(os.path.join(workdir, "logs", "straps_model_logs.pkl"), "rb") as f:
        history = pickle.load(f)
    return history, sorted(os.listdir(os.path.join(workdir, "checkpoints", "model_training")))


def test_train_cli_over_two_ranks(tmp_path, monkeypatch, capfd):
    one, one_ckpts = _train(str(tmp_path / "one"), monkeypatch)
    capfd.readouterr()
    two, two_ckpts = _train(str(tmp_path / "two"), monkeypatch, "data_parallel_devices=2")
    out = capfd.readouterr().out        # the ranks print to the inherited stdout
    assert one_ckpts == two_ckpts == ["straps_model_checkpoint_epoch0.pt"]
    assert out.count("Training completed") == 1 and out.count("epoch 0:") == 1
    saved = load_checkpoint(str(tmp_path / "two" / "checkpoints" / "model_training"
                                / two_ckpts[0]))
    assert saved["epoch"] == 0 and saved["state"]["step"] == 8
    assert set(two) == set(one)
    for k, v in one.items():
        np.testing.assert_allclose(two[k], v, rtol=1e-4, atol=1e-7, err_msg=k)

    # A resume over two ranks at the default learning rate (the configured
    # one, not the checkpoint's 0): every rank reads epoch 0's checkpoint,
    # rank 0 extends the history and writes epoch 1's, and the replicas
    # stay bitwise equal while the parameters move.
    monkeypatch.chdir(tmp_path / "two")
    digests = run_train.main(TRAIN_ARGS + ["data_parallel_devices=2", "num_epochs=2",
                                           "resume_from_epoch=0"])
    assert len(digests) == 2 and digests[0] == digests[1]
    ckpts = tmp_path / "two" / "checkpoints" / "model_training"
    assert sorted(os.listdir(ckpts)) == [f"straps_model_checkpoint_epoch{e}.pt" for e in (0, 1)]
    last = load_checkpoint(str(ckpts / "straps_model_checkpoint_epoch1.pt"))["state"]
    assert last["step"] == 16
    assert [g["lr"] for g in last["optimizer"]["param_groups"]] == [TrainConfig().lr]
    moved = [k for k, v in last["model"].items() if not torch.equal(v, saved["state"]["model"][k])]
    assert "image_encoder.conv1.weight" in moved and "ief_module.fc1.weight" in moved
    with open(tmp_path / "two" / "logs" / "straps_model_logs.pkl", "rb") as f:
        resumed = pickle.load(f)
    for k, v in two.items():
        assert len(resumed[k]) == 2 and resumed[k][:1] == v, k


def test_eval_cli_over_two_ranks(checkpoint, tmp_path, capsys):  # noqa: F811
    data = tmp_path / "eval.npz"
    np.savez(data, **_dataset(6))
    argv = ["--dataset", str(data), "--checkpoint", checkpoint, "--img-wh", "64",
            "--batch-size", "4", "--device", "cpu", "model.compute_dtype=None"]
    one = run_eval.main(argv)
    capsys.readouterr()
    two = run_eval.main(argv + ["--data-parallel-devices", "2"])
    assert json.loads(capsys.readouterr().out) == two
    for k, v in one.items():
        assert abs(two[k] - v) <= 1e-6 * max(abs(v), 1.0), k


def test_more_cards_than_visible_raise_before_any_file(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="requested a 2-device mesh but only 1 device"):
        run_train.main(["--synthetic-data", "data_parallel_devices=2"])
    with pytest.raises(ValueError, match="requested a 2-device mesh but only 1 device"):
        run_eval.main(["--dataset", "missing.npz", "--data-parallel-devices", "2"])
    assert os.listdir(tmp_path) == []


def test_dryrun_over_two_ranks(capsys):
    report = dryrun.main(["2", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == report
    assert (report["ranks"], report["host_rows"], report["predict_rows"]) == (2, 2, 4)
    assert report["checkpoint_bitwise_equal"] and report["predict_max_diff"] <= 1e-4
    assert all(np.isfinite(report["losses"])) and report["collectives"] > 0
