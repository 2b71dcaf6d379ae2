"""The synthetic batch as a CUDA graph (`train/synthetic.py::
generate_synthetic_batch`) on the card.

Skipped where CUDA is absent.  On an H100:
`python -m pytest --noconftest tests/test_torch_synth_graph_cuda.py -q`.

At 256², for the ResNet-18 configuration and the ResNet-50 one with the
silhouette task: six augmented batches of B=16 (eager, capture, four
replays), three of B=8 (eager, capture, replay) and three validation
batches (`augment=False`: eager, capture, replay), each against the eager
body (`_eager_batch`) on the same inputs, bit for bit.
`SYNTH_GRAPH_STATS` counts three captures, six replays and three eager
first calls, the graph map holds three keys, and the packed rasteriser's
launch count grows by one a call, replays included, each launch made
through the module's kernel object (`cuda_raster.packed_raster_kernel`),
where a wrapper records its arguments.  After warm-up the
draws and a replayed batch raise nothing under
`torch.cuda.set_sync_debug_mode("error")`.
"""

import dataclasses

import pytest
import torch

from straps_tpu_torch.config import TrainConfig
from straps_tpu_torch.render import cuda_raster as CR
from straps_tpu_torch.smpl.assets import load_synthetic_assets
from straps_tpu_torch.train import synthetic as SY

pytestmark = pytest.mark.cuda

B, OTHER_B = 16, 8


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return torch.device("cuda")


def _cfg(layers: int, silhouette: bool) -> TrainConfig:
    cfg = TrainConfig(batch_size=B, seed=7)
    cfg.model.resnet_layers = layers
    if silhouette:
        cfg.losses_on = cfg.losses_on + ("silhouette",)
        cfg.init_loss_weights = dict(cfg.init_loss_weights, silhouette=1.0)
    return cfg


def _calls(cfg, assets, dev, plan, seed=3):
    """(draws or None, pose, shape, augment) of each (batch size, augment)."""
    g = torch.Generator().manual_seed(seed)
    draws_gen = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for n, augment in plan:
        pose = (torch.randn(n, 72, generator=g) * 0.2).to(dev)
        shape = (torch.randn(n, 10, generator=g) * 0.5).to(dev)
        draws = SY.draw_synthetic(draws_gen, n, assets.num_verts, cfg, dev) if augment else None
        out.append((draws, pose, shape, augment))
    return out


@pytest.mark.parametrize("layers,silhouette", [(18, False), (50, True)],
                         ids=["r18", "r50_silhouette"])
def test_graph_batches_equal_eager_batches_bit_for_bit(cuda, layers, silhouette):
    cfg = _cfg(layers, silhouette)
    assets = load_synthetic_assets(device=cuda)
    plan = [(B, True)] * 6 + [(OTHER_B, True)] * 3 + [(B, False)] * 3
    calls = _calls(cfg, assets, cuda, plan)
    SY.reset_synth_graph_stats()
    kernel = CR.packed_raster_kernel
    launches, recorded = kernel.launches, []

    def record(*args):
        recorded.append(args)
        return kernel(*args)
    graphed = []
    CR.packed_raster_kernel = record
    try:
        for draws, pose, shape, augment in calls:
            batch = SY.generate_synthetic_batch(draws, pose, shape, assets, cfg,
                                                augment=augment)
            graphed.append([t.clone() for t in batch])  # valid until the key's next call
    finally:
        CR.packed_raster_kernel = kernel
    torch.cuda.synchronize()
    assert kernel.launches - launches == len(calls) == len(recorded)
    assert all(a[0].shape[0] == c[1].shape[0] for a, c in zip(recorded, calls))
    assert SY.SYNTH_GRAPH_STATS == {"captures": 3, "replays": 6,
                                    "eager": {"cpu": 0, "first_of_key": 3}}
    assert len(assets.synth_graphs) == 3
    for i, (got, (draws, pose, shape, augment)) in enumerate(zip(graphed, calls)):
        want = SY._eager_batch(draws, pose, shape, assets, cfg, augment)
        bad = [f for f, a, b in zip(SY.SyntheticBatch._fields, got, want)
               if not torch.equal(a, b)]
        assert not bad, (i, bad)
    # Freed with the assets that hold them.
    moved = assets.to(cuda)
    assert moved.synth_graphs == {} and dataclasses.replace(assets).synth_graphs == {}


def test_draws_and_replayed_batches_never_wait(cuda):
    cfg = _cfg(18, False)
    assets = load_synthetic_assets(device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(5)
    pose = torch.zeros(B, 72, device=cuda)
    shape = torch.zeros(B, 10, device=cuda)
    SY.reset_synth_graph_stats()
    for _ in range(2):                  # eager, then the capture
        SY.generate_synthetic_batch(SY.draw_synthetic(gen, B, assets.num_verts, cfg, cuda),
                                    pose, shape, assets, cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            draws = SY.draw_synthetic(gen, B, assets.num_verts, cfg, cuda)
            batch = SY.generate_synthetic_batch(draws, pose, shape, assets, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert SY.SYNTH_GRAPH_STATS["replays"] == 3
    assert torch.isfinite(batch.proxy).all().item()
