"""Where the synthetic batch runs eagerly (`train/synthetic.py::
generate_synthetic_batch`), on the CPU, and what makes it capturable: CPU
tensors count as eager by reason in `SYNTH_GRAPH_STATS`, keep no graph and
give the eager body's batch (64x64, B=4); the counter resets; the graph's
key changes with the batch size, `augment` and a configuration field; the
constants kept once a device (`utils/device.py::device_constant`) give
`uniform`, the training crop, the joint noise and `face_chunk_row_bounds`
the outputs that tensors made on every call give, bit for bit; and
`pack_planes`, which checks the face attributes once a tensor and
version, still refuses attributes -1 and 8, also when a tensor that
passed is then changed in place, and keeps its note of a tensor no
longer than the tensor.  The stages the two graphs capture (body, the
kernel's arguments; the keys to the batch), run here around the plain
rasteriser, give the eager batch bit for bit; the graph's inputs give back
the draws; `utils/native_build.py::KeyedGraphs` runs a key eagerly, then
captures, then replays, counting each call once.  The graphs themselves
run on the card (`tests/test_torch_synth_graph_cuda.py`).
"""

import dataclasses
import gc

import pytest
import torch

from straps_tpu_torch.augment import draws as D
from straps_tpu_torch.augment import proxy_aug as PA
from straps_tpu_torch.config import TrainConfig
from straps_tpu_torch.geometry import bbox as BB
from straps_tpu_torch.render import cuda_raster as CR
from straps_tpu_torch.render import raster as R
from straps_tpu_torch.smpl.assets import load_synthetic_assets
from straps_tpu_torch.train import synthetic as SY
from straps_tpu_torch.utils.device import device_constant
from straps_tpu_torch.utils.native_build import KeyedGraphs
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

IMG, B = 64, 4


def _cfg() -> TrainConfig:
    return TrainConfig(img_wh=IMG, batch_size=B, focal_length=1250.0)


@pytest.fixture(scope="module")
def tassets():
    return load_synthetic_assets(device="cpu")


def _inputs(cfg, assets, n=B, seed=0):
    g = torch.Generator().manual_seed(seed)
    pose = torch.randn(n, 72, generator=g) * 0.2
    shape = torch.randn(n, 10, generator=g) * 0.5
    return SY.draw_synthetic(g, n, assets.num_verts, cfg, "cpu"), pose, shape


@pytest.mark.parametrize("augment", [True, False], ids=["train", "validation"])
def test_cpu_batches_are_eager_and_equal_the_eager_body(tassets, augment):
    cfg = _cfg()
    assets = dataclasses.replace(tassets)       # a graph map of its own
    calls = [_inputs(cfg, assets, seed=s) for s in range(3)]
    SY.reset_synth_graph_stats()
    got = [SY.generate_synthetic_batch(d, p, s, assets, cfg, augment=augment)
           for d, p, s in calls]
    assert SY.SYNTH_GRAPH_STATS == {"captures": 0, "replays": 0,
                                    "eager": {"cpu": 3, "first_of_key": 0}}
    assert assets.synth_graphs == {}
    for batch, (d, p, s) in zip(got, calls):
        want = SY._eager_batch(d if augment else None, p, s, assets, cfg, augment)
        assert all(torch.equal(a, b) for a, b in zip(batch, want))


def test_reset_zeroes_every_count():
    SY.SYNTH_GRAPH_STATS["replays"] += 2
    SY.SYNTH_GRAPH_STATS["eager"]["first_of_key"] += 1
    SY.reset_synth_graph_stats()
    assert SY.SYNTH_GRAPH_STATS == {"captures": 0, "replays": 0,
                                    "eager": {"cpu": 0, "first_of_key": 0}}


def _key(cfg, assets, n=B, augment=True):
    draws, pose, shape = _inputs(cfg, assets, n)
    return SY._graph_key(SY._graph_inputs(draws, pose, shape, augment), cfg, augment)


def test_the_key_follows_shapes_augment_and_the_configuration(tassets):
    cfg = _cfg()
    key = _key(cfg, tassets)
    assert key == _key(cfg, tassets) and hash(key) == hash(_key(cfg, tassets))
    other_cfg = _cfg()
    other_cfg.proxy_augment.occlude_probability = 0.25
    heatmaps = _cfg()
    heatmaps.heatmap_mode = "legacy"
    others = [_key(cfg, tassets, n=B - 1), _key(cfg, tassets, augment=False),
              _key(other_cfg, tassets), _key(heatmaps, tassets)]
    assert all(k != key for k in others)
    assert len(set(others)) == len(others)


def _per_call(value, dtype, device):
    """What the kept constants replace: a tensor made on every call."""
    return torch.tensor(value, dtype=dtype, device=device)


def _uniform(generator):
    return D.uniform(generator, (B, 17, 2), *PA.occlude_centre_range(IMG, IMG), "cpu")


def _crop(generator):
    segs = (torch.rand((B, IMG, IMG), generator=generator) > 0.7).to(torch.float32)
    joints = torch.rand((B, 17, 2), generator=generator) * IMG
    scale = 1.2 + (torch.rand((B,), generator=generator) - 0.5) * 0.4
    centre = (torch.rand((B, 2), generator=generator) - 0.5) * 10
    return BB.batch_crop_and_resize(segs, joints, IMG, scale, centre)


def _joint_noise(generator):
    joints = torch.rand((B, 17, 2), generator=generator) * IMG
    noise, hips = torch.rand((2, B, 17, 2), generator=generator) * 16 - 8
    return PA.random_joints2d_deviation(joints, noise, hips * 3)


def _row_bounds(generator):
    screen = torch.rand((B, 30, 2), generator=generator) * IMG
    screen[0, 3] = float("nan")
    faces = torch.randint(0, 30, (40, 3), generator=generator, dtype=torch.int32)
    dead = torch.rand((B, 40), generator=generator) > 0.8
    return R.face_chunk_row_bounds(screen, faces, 16, IMG, dead_mask=dead)


@pytest.mark.parametrize("module,fn", [(D, _uniform), (BB, _crop), (PA, _joint_noise),
                                       (R, _row_bounds)],
                         ids=["uniform", "crop", "joint_noise", "row_bounds"])
def test_kept_constants_give_the_per_call_outputs(module, fn, monkeypatch):
    kept = fn(torch.Generator().manual_seed(11))
    monkeypatch.setattr(module, "device_constant", _per_call)
    per_call = fn(torch.Generator().manual_seed(11))
    kept = kept if isinstance(kept, tuple) else (kept,)
    per_call = per_call if isinstance(per_call, tuple) else (per_call,)
    assert all(torch.equal(a, b) for a, b in zip(kept, per_call))


def test_a_constant_is_made_once_for_each_value_dtype_and_device():
    a = device_constant([[1.0, 2.0], [3.0, 4.0]], torch.float32, "cpu")
    assert a is device_constant(((1.0, 2.0), (3.0, 4.0)), torch.float32, torch.device("cpu"))
    assert a is not device_constant([[1.0, 2.0], [3.0, 4.0]], torch.float64, "cpu")
    assert torch.equal(a, torch.tensor([[1.0, 2.0], [3.0, 4.0]]))


def _planes(f):
    g = torch.Generator().manual_seed(f)
    screen = torch.rand((1, 3 * f, 2), generator=g) * IMG
    z = 5.0 + torch.rand((1, 3 * f), generator=g)
    faces = torch.arange(3 * f, dtype=torch.int32).reshape(f, 3)
    return R.prepare_face_planes(screen, z, faces)


@pytest.mark.parametrize("bad", [-1, 8])
def test_pack_planes_refuses_attributes_outside_the_key_bits(bad):
    planes = _planes(4)
    with pytest.raises(ValueError, match=r"face_attr must lie in \[0, 7\]"):
        CR.pack_planes(planes, torch.tensor([1, bad, 3, 0], dtype=torch.int32))
    attr = torch.tensor([1, 2, 3, 7], dtype=torch.int32)
    flat, packed = CR.pack_planes(planes, attr)
    assert torch.equal(packed[:4], attr) and not packed[4:].any()
    CR.pack_planes(planes, attr)                 # checked once, passes again
    attr[1] = bad
    with pytest.raises(ValueError, match=r"face_attr must lie in \[0, 7\]"):
        CR.pack_planes(planes, attr)
    attr[1] = 2
    CR.pack_planes(planes, attr)
    attr[2:][0] = bad                            # through a view
    with pytest.raises(ValueError, match=r"face_attr must lie in \[0, 7\]"):
        CR.pack_planes(planes, attr)
    assert not hasattr(attr, "_attr_range_checked")


def test_the_attribute_note_lives_as_long_as_its_tensor():
    attr = torch.tensor([1, 2, 3, 7], dtype=torch.int32)
    before = len(CR._ATTR_IN_RANGE)
    CR.pack_planes(_planes(4), attr)
    assert len(CR._ATTR_IN_RANGE) == before + 1
    del attr
    gc.collect()
    assert len(CR._ATTR_IN_RANGE) == before


@pytest.mark.parametrize("augment", [True, False], ids=["train", "validation"])
def test_the_graphs_stages_around_the_rasteriser_give_the_eager_batch(tassets, augment):
    cfg = _cfg()
    draws, pose, shape = _inputs(cfg, tassets, seed=5)
    draws = draws if augment else None
    body = SY._body(draws, pose, shape, tassets, cfg, augment)
    planes, bounds = SY._part_seg_planes(body, tassets, cfg)
    flat, attr = CR.pack_planes(planes, tassets.face_parts)
    keys = CR.rasterize_packed_reference(flat, bounds.to(torch.int32).contiguous(), attr,
                                         IMG, IMG)
    got = SY._proxy_batch(body, CR.unpack_keys(keys)[0].to(torch.float32), draws, cfg,
                          augment)
    want = SY._eager_batch(draws, pose, shape, tassets, cfg, augment)
    assert [f for f, a, b in zip(SY.SyntheticBatch._fields, got, want)
            if not torch.equal(a, b)] == []


def test_the_graph_inputs_give_back_the_draws(tassets):
    draws, pose, shape = _inputs(_cfg(), tassets)
    inputs = SY._graph_inputs(draws, pose, shape, True)
    assert len(inputs) == 2 + len(SY._TENSOR_DRAWS) + len(draws.proxy)
    got, got_pose, got_shape = SY._from_inputs(inputs, True)
    assert got_pose is pose and got_shape is shape
    assert got._fields == draws._fields and got.proxy._fields == draws.proxy._fields
    assert all(a is b for a, b in zip(got[:-1] + tuple(got.proxy),
                                      draws[:-1] + tuple(draws.proxy)))
    assert SY._from_inputs(SY._graph_inputs(None, pose, shape, False), False) == (
        None, pose, shape)


def test_keyed_graphs_run_eagerly_then_capture_then_replay():
    stats = KeyedGraphs("first", "cpu")
    graphs, log = {}, []

    def call(key):
        return stats.call(graphs, key, capture=lambda: log.append(("capture", key)) or key,
                          replay=lambda g: ("replay", g), eager=lambda: ("eager", key))
    assert [call("a"), call("a"), call("b"), call("a")] == [
        ("eager", "a"), ("replay", "a"), ("eager", "b"), ("replay", "a")]
    assert log == [("capture", "a")] and set(graphs) == {"a", "b"}
    assert stats.run_eager("cpu", lambda: 3) == 3
    assert stats == {"captures": 1, "replays": 1, "eager": {"cpu": 1, "first": 2}}
    stats.reset()
    assert stats == {"captures": 0, "replays": 0, "eager": {"cpu": 0, "first": 0}}
