"""Where the training update runs eagerly (`train/step.py::train_on_batch`),
on the CPU: a CPU state's updates and a two-rank gloo mesh's count as
eager by reason in `UPDATE_GRAPH_STATS` and keep no graph, and their
outputs are the eager body's (64x64, B=4, ResNet-18, float32 encoder);
the counter resets; the SMPL gathers' index tensors are made once a
device and gather what the lists gather.  The graph itself runs on the
card (`tests/test_torch_update_graph_cuda.py`).
"""

import numpy as np
import pytest
import torch

from straps_tpu_torch import constants as C
from straps_tpu_torch.config import TrainConfig
from straps_tpu_torch.parallel import launch
from straps_tpu_torch.parallel.dryrun import train_steps
from straps_tpu_torch.smpl import model as M
from straps_tpu_torch.smpl.assets import load_synthetic_assets
from straps_tpu_torch.train import step as S
from straps_tpu_torch.train.loop import build_training
from straps_tpu_torch.train.synthetic import draw_synthetic, generate_synthetic_batch
from straps_tpu_torch.utils import device as D
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

IMG, B = 64, 4
TIMEOUT_S = 120


def _cfg() -> TrainConfig:
    cfg = TrainConfig(img_wh=IMG, batch_size=B, focal_length=1250.0)
    cfg.model.compute_dtype = None
    cfg.metrics_to_track = ("pves", "pves_pa", "mpjpes_pa", "shape_mses")
    return cfg


@pytest.fixture(scope="module")
def tassets():
    return load_synthetic_assets(device="cpu")


def _steps(cfg, tassets, n, seed=0):
    rng = np.random.RandomState(seed)
    generator = torch.Generator().manual_seed(seed + 1)
    return [(draw_synthetic(generator, B, tassets.num_verts, cfg, "cpu"),
             torch.tensor((rng.randn(B, 72) * 0.2).astype(np.float32)),
             torch.tensor((rng.randn(B, 10) * 0.5).astype(np.float32)))
            for _ in range(n)]


def test_cpu_updates_are_eager_and_equal_the_eager_body(tassets):
    cfg = _cfg()
    _, assets, state, _, _ = build_training(cfg, tassets, device="cpu")
    _, _, twin, _, _ = build_training(cfg, tassets, device="cpu")
    batches = [generate_synthetic_batch(d, p, s, assets, cfg, augment=True)
               for d, p, s in _steps(cfg, tassets, 3)]
    S.reset_update_graph_stats()
    got = [S.train_on_batch(state, b, assets, cfg) for b in batches]
    assert S.UPDATE_GRAPH_STATS == {"captures": 0, "replays": 0,
                                    "eager": {"cpu": 3, "mesh": 0, "first_of_shape": 0}}
    assert state.update_graphs == {}
    want = [S._eager_update(twin, b, assets, cfg) for b in batches]
    for (gl, gt, gf), (wl, wt, wf) in zip(got, want):
        assert torch.equal(gl, wl)
        assert gt.keys() == wt.keys() and all(torch.equal(gt[k], wt[k]) for k in gt)
        assert list(gf) == list(wf) and all(torch.equal(gf[k], wf[k]) for k in gf)
    assert state.step == twin.step == 3
    assert state.digest() == twin.digest()
    for p, q in zip(state.optimizer.param_groups[0]["params"],
                    twin.optimizer.param_groups[0]["params"]):
        assert torch.equal(p.grad, q.grad)


def test_reset_zeroes_every_count():
    S.UPDATE_GRAPH_STATS["replays"] += 2
    S.UPDATE_GRAPH_STATS["eager"]["mesh"] += 1
    S.reset_update_graph_stats()
    assert S.UPDATE_GRAPH_STATS == {"captures": 0, "replays": 0,
                                    "eager": {"cpu": 0, "mesh": 0, "first_of_shape": 0}}


def steps_with_stats(cfg, steps):
    """`train_steps` on this rank, with the rank's update counter."""
    S.reset_update_graph_stats()
    out = train_steps(cfg, steps)
    return out, {k: v if isinstance(v, int) else dict(v)
                 for k, v in S.UPDATE_GRAPH_STATS.items()}


def test_mesh_updates_are_eager_and_stay_the_global_batch_step(tassets):
    """Two gloo ranks, two steps: each rank counts two eager updates over
    the mesh, and the steps hold to the one-process global-batch step as
    `tests/test_torch_parallel_train.py` holds them."""
    cfg = _cfg()
    steps = _steps(cfg, tassets, 2, seed=5)
    one, stats = steps_with_stats(cfg, steps)
    assert stats["eager"] == {"cpu": 2, "mesh": 0, "first_of_shape": 0}
    ranks = launch(steps_with_stats, 2, "cpu", args=(cfg, steps), timeout_s=TIMEOUT_S)
    for _, rank_stats in ranks:
        assert rank_stats == {"captures": 0, "replays": 0,
                              "eager": {"cpu": 0, "mesh": 2, "first_of_shape": 0}}
    (two, _), (other, _) = ranks
    assert two["digest"] == other["digest"]
    for want, got in zip(one["steps"], two["steps"]):
        assert abs(got["loss"] - want["loss"]) < 1e-4, (got["loss"], want["loss"])
        for k, v in want["tasks"].items():
            assert abs(got["tasks"][k] - v) < 1e-4, k
    for k, v in one["steps"][0]["per_frame"].items():
        np.testing.assert_allclose(two["steps"][0]["per_frame"][k], v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_smpl_index_tensors_are_made_once_and_gather_as_the_lists(tassets):
    dev = torch.device("cpu")
    ids = tuple(C.ALL_JOINTS_TO_COCO_MAP)
    idx = M.device_index(ids, dev)
    assert idx is M.device_index(ids, dev) and idx.dtype == torch.int64
    joints = torch.randn(3, 90, 3)
    assert torch.equal(joints[:, idx], joints[:, list(ids)])
    betas = torch.randn(2, 10) * 0.5
    out = M.smpl_forward(tassets, betas, M.rodrigues(torch.randn(2, 23, 3) * 0.3),
                         M.rodrigues(torch.randn(2, 1, 3) * 0.3))
    extra = [C.SMPL_VERTEX_IDS[k] for k in C.SMPL_EXTRA_KEYPOINT_ORDER]
    assert torch.equal(out.joints[:, 24:24 + len(extra)], out.vertices[:, extra])
    h36m, coco = M.select_joint_sets(out.joints)
    assert torch.equal(h36m, out.joints[:, C.ALL_JOINTS_TO_H36M_MAP][:, C.H36M_TO_J14])
    assert torch.equal(coco, out.joints[:, C.ALL_JOINTS_TO_COCO_MAP])


def test_smpl_index_tensors_made_in_inference_mode_serve_training(tassets):
    """An index first made under `torch.inference_mode` (predict) is a
    normal tensor: a later training forward saves it for backward."""
    D._constant.cache_clear()
    with torch.inference_mode():
        M.select_joint_sets(M.smpl_forward(tassets, torch.zeros(1, 10),
                                           M.rodrigues(torch.zeros(1, 23, 3)),
                                           M.rodrigues(torch.zeros(1, 1, 3))).joints)
    betas = torch.zeros(2, 10, requires_grad=True)
    out = M.smpl_forward(tassets, betas, M.rodrigues(torch.randn(2, 23, 3) * 0.3),
                         M.rodrigues(torch.randn(2, 1, 3) * 0.3))
    h36m, coco = M.select_joint_sets(out.joints)
    (h36m.sum() + coco.sum()).backward()
    assert torch.isfinite(betas.grad).all()
