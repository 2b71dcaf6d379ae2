"""The training update as a CUDA graph (`train/step.py::train_on_batch`) on
the card.

Skipped where CUDA is absent.  On an H100:
`python -m pytest --noconftest tests/test_torch_update_graph_cuda.py -q`.

From one seeded state at 256², B=16, bfloat16 encoder (ResNet-18, and
ResNet-50 with the silhouette task), five steps through `train_on_batch`
(eager, capture, three replays), two of another batch size (eager,
capture) and one more of the first size, against the same eight steps
through the eager body (`_eager_update`) called directly, cuDNN
deterministic on both sides: the losses, task losses and per-frame
metrics of every step, the parameters, their last gradients, the
BatchNorm running statistics and `num_batches_tracked`, and Adam's
moments and step counts are bitwise equal.  `UPDATE_GRAPH_STATS` counts
two captures, four replays and two eager first updates, and the
BatchNorm kernels' launch count is four a layer a step either way.  In
the replayed steps nothing waits for the device but the Procrustes
metrics' SVD, which checks on the host that it converged; without those
metrics the replayed steps raise nothing under
`torch.cuda.set_sync_debug_mode("error")`.
"""

import warnings

import pytest
import torch

from straps_tpu_torch.config import TrainConfig
from straps_tpu_torch.models import batchnorm as BN
from straps_tpu_torch.train import step as S
from straps_tpu_torch.train.loop import build_training
from straps_tpu_torch.train.synthetic import draw_synthetic, generate_synthetic_batch

pytestmark = pytest.mark.cuda

B, OTHER_B = 16, 8


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return torch.device("cuda")


@pytest.fixture()
def deterministic_cudnn():
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def _cfg(layers: int, silhouette: bool, metrics=None) -> TrainConfig:
    cfg = TrainConfig(batch_size=B, seed=7)
    cfg.model.resnet_layers = layers
    if silhouette:
        cfg.losses_on = cfg.losses_on + ("silhouette",)
        cfg.init_loss_weights = dict(cfg.init_loss_weights, silhouette=1.0)
    if metrics is not None:
        cfg.metrics_to_track = metrics
    return cfg


def _batches(cfg, assets, dev, sizes, seed=3):
    g = torch.Generator().manual_seed(seed)
    draws_gen = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for n in sizes:
        pose = (torch.randn(n, 72, generator=g) * 0.2).to(dev)
        shape = (torch.randn(n, 10, generator=g) * 0.5).to(dev)
        draws = draw_synthetic(draws_gen, n, assets.num_verts, cfg, dev)
        out.append(generate_synthetic_batch(draws, pose, shape, assets, cfg, augment=True))
    return out


def _host(loss, tasks, per_frame):
    return (loss.cpu(), {k: v.cpu() for k, v in tasks.items()},
            {k: v.cpu() for k, v in per_frame.items()})


def _state_tensors(state):
    out = {f"param.{k}": p.detach().cpu() for k, p in state.model.named_parameters()}
    out.update({f"grad.{k}": p.grad.cpu() for k, p in state.model.named_parameters()})
    out.update({f"buffer.{k}": b.cpu() for k, b in state.model.named_buffers()})
    out.update({f"log_var.{k}": v.detach().cpu() for k, v in state.log_vars.items()})
    out.update({f"log_var_grad.{k}": v.grad.cpu() for k, v in state.log_vars.items()})
    params = state.optimizer.param_groups[0]["params"]
    for i, p in enumerate(params):
        for k, v in state.optimizer.state[p].items():
            out[f"adam.{i}.{k}"] = v.cpu()
    return out


def _equal(a, b, what):
    assert a.keys() == b.keys(), what
    bad = [k for k in a if not torch.equal(a[k], b[k])]
    assert not bad, f"{what}: {bad[:5]}"


@pytest.mark.parametrize("layers,silhouette", [(18, False), (50, True)],
                         ids=["r18", "r50_silhouette"])
def test_graph_updates_equal_eager_updates_bit_for_bit(cuda, deterministic_cudnn, layers,
                                                       silhouette):
    cfg = _cfg(layers, silhouette)
    _, assets, graph_state, _, _ = build_training(cfg, device=cuda)
    _, _, eager_state, _, _ = build_training(cfg, assets, device=cuda)
    batches = _batches(cfg, assets, cuda, [B] * 5 + [OTHER_B] * 2 + [B])
    norms = sum(isinstance(m, BN.BatchNorm2d) for m in graph_state.model.modules())

    S.reset_update_graph_stats()
    launches = BN.batchnorm_kernels.launches
    graphed, sync_warnings = [], []
    for i, batch in enumerate(batches):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if i in (2, 3, 4, 7):          # the replays
                torch.cuda.set_sync_debug_mode("warn")
            try:
                out = S.train_on_batch(graph_state, batch, assets, cfg)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        sync_warnings += [w for w in caught if "called a synchronizing" in str(w.message)]
        graphed.append(_host(*out))
    torch.cuda.synchronize()
    assert BN.batchnorm_kernels.launches - launches == 4 * norms * len(batches)
    assert S.UPDATE_GRAPH_STATS == {"captures": 2, "replays": 4,
                                    "eager": {"cpu": 0, "mesh": 0, "first_of_shape": 2}}
    assert len(graph_state.update_graphs) == 2
    # Only the solves of pves_pa and mpjpes_pa wait, checking their results.
    print(f"sync warnings in {len(batches) - 4} replays: {len(sync_warnings)}")
    assert all(w.filename.endswith("geometry/alignment.py") for w in sync_warnings), [
        (w.filename, w.lineno, str(w.message)[:200]) for w in sync_warnings
        if not w.filename.endswith("geometry/alignment.py")]

    eager = [_host(*S._eager_update(eager_state, batch, assets, cfg)) for batch in batches]
    assert graph_state.step == eager_state.step == len(batches)
    for i, ((gl, gt, gf), (el, et, ef)) in enumerate(zip(graphed, eager)):
        assert torch.equal(gl, el), (i, gl, el)
        _equal(gt, et, f"step {i} task losses")
        _equal(gf, ef, f"step {i} per-frame metrics")
    _equal(_state_tensors(graph_state), _state_tensors(eager_state), "state")


def test_replays_without_procrustes_metrics_never_wait(cuda):
    cfg = _cfg(18, False, metrics=("pves", "pves_sc", "pve-ts", "mpjpes", "mpjpes_sc",
                                    "shape_mses", "pose_mses", "joints2D_l2es"))
    _, assets, state, _, _ = build_training(cfg, device=cuda)
    batches = _batches(cfg, assets, cuda, [B] * 5, seed=4)
    S.reset_update_graph_stats()
    for batch in batches[:2]:
        S.train_on_batch(state, batch, assets, cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [S.train_on_batch(state, batch, assets, cfg) for batch in batches[2:]]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert S.UPDATE_GRAPH_STATS["replays"] == 3
    assert all(torch.isfinite(loss).item() for loss, _, _ in outs)
