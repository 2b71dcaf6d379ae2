"""The DensePose training side of the PyTorch port (`straps_tpu_torch/
perception/densepose.py`: the DeepLab head, `densepose_losses`,
`densepose_data_filter`, the IUV wire format) against the JAX package's,
on the same numpy inputs made from a seed.

Tolerances: the DeepLab head within 1e-5 of its largest output against
the detectron2 twin (`tests/torch_twin_d2.py::DeepLabHeadTwin`) loaded
from the same state dict, and within the JAX suite's own atol 5e-4 / rtol
1e-3 (`tests/test_perception_parity.py::TestDeepLabHeadParity`) against
the JAX head carried across by `flax_detector_to_torch_state_dict`; the
pickle round trip exact.  Each loss term within 1e-5 relative of the JAX
one, the gradients with respect to s, i, u and v within 1e-5 of each
one's largest against `jax.grad`; no valid point gives exactly 0.  The
data filter, `iuv_to_uint8_image` and the codec exact;
`densepose_result_uint8` at the JAX suite's bounds
(`tests/test_perception_extras.py::test_densepose_result_uint8_matches_torch`):
labels equal on more than 0.999 of the pixels, U and V within one level,
on under 0.5% of them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from straps_tpu.perception import densepose as JD
from straps_tpu.perception.convert_d2 import convert_d2_state
from straps_tpu_torch.perception import densepose as TD
from straps_tpu_torch.perception.convert_d2 import (
    flax_detector_to_torch_state_dict, load_d2_pkl, load_detector_state, save_d2_pkl,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)
from torch_twin_d2 import DeepLabHeadTwin, twin_state_to_d2

PREFIX = "roi_heads.densepose_head."
# The JAX parity test's sizes.
CIN, HIDDEN, N_CONVS, S, R = 64, 96, 2, 14, 3


def _twin(nonlocal_on, seed=3):
    torch.manual_seed(seed)
    twin = DeepLabHeadTwin(cin=CIN, hidden=HIDDEN, n_convs=N_CONVS, nonlocal_on=nonlocal_on)
    if nonlocal_on:
        # The reference starts the NL block's GroupNorm at 0 (an identity
        # block); randomised so that the block is exercised.
        with torch.no_grad():
            twin.NLBlock.W[1].weight.uniform_(0.5, 1.5)
            twin.NLBlock.W[1].bias.uniform_(-0.2, 0.2)
    return twin.eval()


def _head(nonlocal_on):
    return TD.DensePoseDeepLabHead(CIN, HIDDEN, N_CONVS, use_nonlocal=nonlocal_on)


def _nchw(a):
    return torch.as_tensor(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("nonlocal_on", [False, True])
def test_deeplab_head_matches_the_detectron2_twin(nonlocal_on):
    twin = _twin(nonlocal_on)
    head = _head(nonlocal_on)
    head.load_state_dict({k: torch.as_tensor(v) for k, v in twin_state_to_d2(twin).items()},
                         strict=True)
    x = torch.as_tensor(np.random.RandomState(4).randn(R, CIN, S, S).astype(np.float32))
    with torch.no_grad():
        got, want = head(x), twin(x)
    assert got.shape == (R, HIDDEN, S, S)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("nonlocal_on", [False, True])
def test_deeplab_head_matches_jax_through_the_flax_converter(nonlocal_on):
    """The JAX head's variables (its init, every tensor moved by a seeded
    uniform, the NL GroupNorm away from 0) go to the port through the
    converter; the outputs agree within the JAX suite's bounds."""
    x = np.random.RandomState(5).randn(R, S, S, CIN).astype(np.float32)
    jhead = JD.DensePoseDeepLabHead(conv_dim=HIDDEN, num_convs=N_CONVS, use_nonlocal=nonlocal_on)
    variables = jhead.init(jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.RandomState(6)
    params = jax.tree_util.tree_map(
        lambda t: np.asarray(t) + rng.uniform(-0.1, 0.1, t.shape).astype(np.float32),
        variables["params"])
    if nonlocal_on:
        params["nonlocal"]["gn_w"]["scale"] = rng.uniform(0.5, 1.5, (CIN,)).astype(np.float32)
    state = flax_detector_to_torch_state_dict({"params": {"densepose_head": params}})
    assert all(k.startswith(PREFIX) for k in state)
    head = _head(nonlocal_on)
    head.load_state_dict({k[len(PREFIX):]: torch.as_tensor(v) for k, v in state.items()},
                         strict=True)
    want = np.asarray(jhead.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(head(_nchw(x)))
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-3)
    print(f"DeepLab head (NonLocal {nonlocal_on}) against JAX: largest difference "
          f"{np.abs(got - want).max():.3e} of {np.abs(want).max():.3f}")


@pytest.mark.parametrize("nonlocal_on", [False, True])
def test_deeplab_pickle_and_flax_tree_give_the_same_module(nonlocal_on, tmp_path):
    """A detectron2 DeepLab pickle loads with `strict=True`; its JAX
    conversion carried back through `flax_detector_to_torch_state_dict`
    is the same state, and a `save_d2_pkl` round trip is exact."""
    d2 = {PREFIX + k: v for k, v in twin_state_to_d2(_twin(nonlocal_on)).items()}
    path = str(tmp_path / "dl.pkl")
    save_d2_pkl(path, {k: torch.as_tensor(v) for k, v in d2.items()})
    loaded = load_d2_pkl(path)
    assert sorted(loaded) == sorted(d2)
    for k, v in d2.items():
        assert torch.equal(loaded[k], torch.as_tensor(v)), k
    back = flax_detector_to_torch_state_dict(convert_d2_state(d2))
    assert sorted(back) == sorted(d2)
    for k, v in d2.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    head = _head(nonlocal_on)
    state = {k[len(PREFIX):]: v for k, v in loaded.items()}
    load_detector_state(head, state)
    assert sorted(head.state_dict()) == sorted(state)
    save_d2_pkl(str(tmp_path / "again.pkl"), {PREFIX + k: v for k, v in head.state_dict().items()})
    again = load_d2_pkl(str(tmp_path / "again.pkl"))
    assert all(torch.equal(again[k], loaded[k]) for k in loaded)


def test_nonlocal_block_starts_as_the_identity():
    block = TD.NonLocalBlock2D(64)
    x = torch.randn(2, 64, 14, 14)
    with torch.no_grad():
        assert torch.equal(block(x), x)
    assert block.W[1].eps == 1e-5 and block.W[1].num_groups == 32


# ------------------------------------------------------------- losses --

def _loss_inputs(seed, R_, S_, P, invalid_share):
    rng = np.random.RandomState(seed)
    return dict(
        s=rng.randn(R_, S_, S_, 15).astype(np.float32),
        i=rng.randn(R_, S_, S_, 25).astype(np.float32),
        u=rng.rand(R_, S_, S_, 25).astype(np.float32) * 1.6 - 0.3,
        v=rng.rand(R_, S_, S_, 25).astype(np.float32) * 1.6 - 0.3,
        gt_segm=rng.randint(0, 15, (R_, S_, S_)).astype(np.int32),
        gt_points01=rng.rand(R_, P, 2).astype(np.float32),
        gt_part=rng.randint(0, 25, (R_, P)).astype(np.int32),
        gt_u=rng.rand(R_, P).astype(np.float32),
        gt_v=rng.rand(R_, P).astype(np.float32),
        point_valid=rng.rand(R_, P) >= invalid_share)


def _torch_losses(inp, grads=False):
    maps = {k: _nchw(inp[k]).requires_grad_(grads) for k in "siuv"}
    rest = {k: torch.as_tensor(inp[k]) for k in inp if k not in "siuv"}
    return TD.densepose_losses(**maps, **rest), maps


def _jax_losses(inp):
    return JD.densepose_losses(**{k: jnp.asarray(v) for k, v in inp.items()})


@pytest.mark.parametrize("shape", [(2, 16, 20, 0.0), (4, 56, 64, 0.3)],
                         ids=["jax_test_shapes", "s56_some_invalid"])
def test_losses_and_gradients_match_jax(shape):
    inp = _loss_inputs(1, *shape)
    got, maps = _torch_losses(inp, grads=True)
    want = _jax_losses(inp)
    for k in ("total", "segm", "part", "u", "v"):
        w = float(want[k])
        assert abs(got[k].item() - w) <= 1e-5 * abs(w), (k, got[k].item(), w)
    got["total"].backward()

    def total(s, i, u, v):
        return JD.densepose_losses(s, i, u, v, **{k: jnp.asarray(inp[k]) for k in inp
                                                  if k not in "siuv"})["total"]
    jgrads = jax.grad(total, argnums=(0, 1, 2, 3))(*(jnp.asarray(inp[k]) for k in "siuv"))
    for k, jg in zip("siuv", jgrads):
        jg = np.asarray(jg)
        g = _nhwc(maps[k].grad)
        assert np.abs(g - jg).max() <= 1e-5 * np.abs(jg).max(), k


def test_losses_without_valid_points_are_zero():
    inp = _loss_inputs(2, 2, 16, 20, 0.0)
    inp["point_valid"] = np.zeros_like(inp["point_valid"])
    inp["gt_part"][:] = 99          # read nowhere: every point is invalid
    got, _ = _torch_losses(inp)
    for k in ("part", "u", "v"):
        assert float(got[k]) == 0.0, k
    assert float(got["total"]) == 2.0 * float(got["segm"]) > 0


def test_losses_of_a_perfect_segmentation():
    """The JAX suite's check: one-hot S logits of 20 give a coarse
    segmentation loss under 1e-3, as the JAX function's."""
    inp = _loss_inputs(0, 2, 16, 20, 0.0)
    inp["s"] = (np.eye(15, dtype=np.float32)[inp["gt_segm"]] * 20.0)
    got, _ = _torch_losses(inp)
    assert float(got["segm"]) < 1e-3
    assert abs(float(got["segm"]) - float(_jax_losses(inp)["segm"])) <= 1e-5 * float(got["segm"])


# ------------------------------------------------------- data and wire --

def test_data_filter_matches_jax():
    props = np.asarray([[0, 0, 10, 10], [0, 0, 10, 10], [0, 0, 5, 10], [0, 0, 10, 10]],
                       np.float32)
    gts = np.asarray([[0, 0, 10, 10]] * 4, np.float32)
    has_dp = np.asarray([True, False, True, True])
    valid = np.asarray([True, True, True, False])
    rng = np.random.RandomState(7)
    gt_r = np.sort(rng.uniform(0, 200, (256, 2, 2)), axis=1).reshape(256, 4)
    size = np.tile(gt_r[:, 2:] - gt_r[:, :2], 2)
    jitter = rng.normal(0, 1, (256, 4)) * size * rng.choice([0.02, 0.08, 0.3], (256, 1))
    props_r = (gt_r + jitter).astype(np.float32)
    cases = [(props, gts, has_dp, valid),
             (props_r, gt_r.astype(np.float32), rng.rand(256) > 0.2, rng.rand(256) > 0.1)]
    for p, g, h, v in cases:
        want = np.asarray(JD.densepose_data_filter(jnp.asarray(p), jnp.asarray(g),
                                                   jnp.asarray(h), jnp.asarray(v)))
        got = TD.densepose_data_filter(*(torch.as_tensor(a) for a in (p, g, h, v))).numpy()
        np.testing.assert_array_equal(got, want)
    assert 0.2 < got.mean() < 0.8
    np.testing.assert_array_equal(
        TD.densepose_data_filter(*(torch.as_tensor(a) for a in cases[0])).numpy(),
        [True, False, False, False])


def test_iuv_to_uint8_image_matches_jax():
    rng = np.random.RandomState(8)
    part = rng.randint(0, 25, (56, 56))
    u = rng.uniform(-0.5, 1.5, (56, 56)).astype(np.float32)
    v = rng.uniform(-0.5, 1.5, (56, 56)).astype(np.float32)
    want = JD.iuv_to_uint8_image(part, u, v)
    np.testing.assert_array_equal(TD.iuv_to_uint8_image(part, u, v), want)
    np.testing.assert_array_equal(
        TD.iuv_to_uint8_image(torch.as_tensor(part), torch.as_tensor(u), torch.as_tensor(v)),
        want)


@pytest.mark.parametrize("box", [[12.7, 5.2, 100.4, 118.9], [30.0, 40.0, 30.5, 41.0],
                                 [3.0, 9.5, 61.9, 33.2]])
def test_densepose_result_uint8_matches_jax(box):
    rng = np.random.RandomState(3)
    s = rng.randn(56, 56, 2).astype(np.float32)
    i = rng.randn(56, 56, 25).astype(np.float32)
    u = rng.rand(56, 56, 25).astype(np.float32)
    v = rng.rand(56, 56, 25).astype(np.float32)
    want = JD.densepose_result_uint8(s, i, u, v, np.asarray(box, np.float32))
    got = TD.densepose_result_uint8(*(_nchw(a[None])[0] for a in (s, i, u, v)),
                                    torch.tensor(box))
    assert got.shape == want.shape and got.dtype == np.uint8
    assert (got[..., 0] == want[..., 0]).mean() > 0.999
    duv = np.abs(got[..., 1:].astype(int) - want[..., 1:].astype(int))[got[..., 0] == want[..., 0]]
    assert duv.max() <= 1 and (duv > 0).mean() < 0.005


def test_densepose_result_uint8_is_the_reference_resize():
    """The port's result is detectron2's `_output_to_result` as the JAX
    suite writes it in torch: resize, argmax, select, scale, truncate."""
    g = torch.Generator().manual_seed(9)
    s, i = torch.randn(15, 56, 56, generator=g), torch.randn(25, 56, 56, generator=g)
    u, v = torch.rand(25, 56, 56, generator=g), torch.rand(25, 56, 56, generator=g)
    box = [7.3, 2.9, 51.0, 80.6]
    h, w = int(box[3] - box[1]), int(box[2] - box[0])
    rs = {k: F.interpolate(t[None], (h, w), mode="bilinear", align_corners=False)[0]
          for k, t in (("s", s), ("i", i), ("u", u), ("v", v))}
    part = (rs["i"].argmax(0) * (rs["s"].argmax(0) > 0)).numpy()
    ref = np.zeros((h, w, 3), np.uint8)
    ref[..., 0] = part
    for pid in range(1, 25):
        sel = part == pid
        ref[..., 1][sel] = (rs["u"][pid].numpy()[sel] * 255).clip(0, 255).astype(np.uint8)
        ref[..., 2][sel] = (rs["v"][pid].numpy()[sel] * 255).clip(0, 255).astype(np.uint8)
    np.testing.assert_array_equal(TD.densepose_result_uint8(s, i, u, v, box), ref)


def test_iuv_codec_both_directions_across_the_packages():
    rng = np.random.RandomState(0)
    for shape in ((24, 32, 3), (1, 1, 3), (57, 13, 3)):
        iuv = rng.randint(0, 256, shape).astype(np.uint8)
        iuv[: shape[0] // 2] = 7                   # flat rows: Pillow picks other filters
        ours, theirs = TD.encode_iuv_png(iuv), JD.encode_iuv_png(iuv)
        assert isinstance(ours, str)
        np.testing.assert_array_equal(JD.decode_iuv_png(ours), iuv)
        np.testing.assert_array_equal(TD.decode_iuv_png(theirs), iuv)
        np.testing.assert_array_equal(TD.decode_iuv_png(ours), iuv)
    with pytest.raises(ValueError, match="not a PNG file"):
        TD.decode_iuv_png("AAAA")
