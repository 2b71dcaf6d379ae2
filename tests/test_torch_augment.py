"""The PyTorch port's augmentations, training crop, joint visibility and
synthetic batch against the JAX package's, given the same random draws.

The port's functions take their draws as tensors; here those are the
values of the JAX package's own `jax.random` calls, made from the JAX keys
in its split order (`jax_draws`).  Tolerances: masks, part maps and
integer corners exactly; float outputs atol 1e-6.

`generate_synthetic_batch` runs at 64x64, B=4, focal length 1250, on both
paths (validation without draws; training with the JAX draws).  The JAX
side renders through the packed Pallas kernel in interpret mode with back
faces culled, the function the port's renderer computes.  An edge pixel of
the pre-crop render may move with float32 vertex rounding, and the crop
box follows the silhouette's bounding box, so the crop corners are held
equal first; then the silhouette channel's mismatch < 0.002, heatmaps atol
1e-5, target vertices and joints atol 1e-5, cropped joints2D atol 1e-3 px.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from straps_tpu import augment as JA
from straps_tpu.config import TrainConfig as JaxTrainConfig
from straps_tpu.geometry import bbox as JB
from straps_tpu.geometry import joints as JJ
from straps_tpu.smpl import load_synthetic_assets
from straps_tpu.train import synthetic as JS
from straps_tpu_torch.augment import cam_aug as TCA
from straps_tpu_torch.augment import proxy_aug as TPA
from straps_tpu_torch.augment import smpl_aug as TSA
from straps_tpu_torch.config import ProxyAugmentConfig, SmplAugmentConfig, TrainConfig
from straps_tpu_torch.geometry import bbox as TB
from straps_tpu_torch.geometry import joints as TJ
from straps_tpu_torch.smpl.assets import load_synthetic_assets as torch_assets
from straps_tpu_torch.train import synthetic as TS
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

IMG, B = 64, 4
ATOL = 1e-6


def jax_draws(key, B, V, cfg: TrainConfig) -> TS.SyntheticDraws:
    """The draws of `straps_tpu.train.synthetic.generate_synthetic_batch`
    for `key`, made by its own `jax.random` calls in its split order, as
    the port's `SyntheticDraws` (CPU tensors)."""
    r = jax.random
    keys = r.split(key, 6)
    kxy, kz = r.split(keys[1])
    k_rm, k_occ, k_dev = r.split(keys[5], 3)
    rm_keys = r.split(k_rm, len(cfg.proxy_augment.remove_appendages_classes))
    kc, kp = r.split(k_occ)
    k1, k2 = r.split(k_dev)
    pa, ba = cfg.proxy_augment, cfg.bbox_augment
    lo = jnp.asarray([IMG / 2.0 - 0.3 * IMG / 2.0] * 2)
    hi = jnp.asarray([IMG / 2.0 + 0.3 * IMG / 2.0] * 2)
    t = lambda x: torch.tensor(np.asarray(x))  # noqa: E731
    proxy = TPA.ProxyDraws(
        verts_noise=t(r.uniform(keys[2], (B, V, 2), minval=pa.delta_verts2d_dev_range[0],
                                maxval=pa.delta_verts2d_dev_range[1])),
        remove=t(jnp.stack([r.uniform(k, (B,)) for k in rm_keys])),
        occlude_centre=t(r.uniform(kc, (B, 2), minval=lo, maxval=hi)),
        occlude=t(r.uniform(kp, (B,))),
        joints_noise=t(r.uniform(k1, (B, 17, 2), minval=pa.delta_j2d_dev_range[0],
                                 maxval=pa.delta_j2d_dev_range[1])),
        hip_noise=t(r.uniform(k2, (B, 17, 2), minval=pa.delta_j2d_hip_dev_range[0],
                              maxval=pa.delta_j2d_hip_dev_range[1])))
    return TS.SyntheticDraws(
        delta_betas=t(r.normal(keys[0], (B, 10))),
        cam_xy=t(r.normal(kxy, (B, 2))),
        cam_z=t(r.uniform(kz, (B,), minval=cfg.cam_augment.delta_z_range[0],
                          maxval=cfg.cam_augment.delta_z_range[1])),
        crop_scale=t(r.uniform(keys[3], (B,), minval=ba.delta_scale_range[0],
                               maxval=ba.delta_scale_range[1])),
        crop_centre=t(r.uniform(keys[4], (B, 2), minval=ba.delta_centre_range[0],
                                maxval=ba.delta_centre_range[1])),
        proxy=proxy)


def _key(i):
    return jax.random.PRNGKey(i)


@pytest.mark.parametrize("dist", ["normal", "uniform", "off"])
def test_augment_smpl(dist):
    rng = np.random.RandomState(0)
    orig = rng.randn(B, 10).astype(np.float32)
    pose = (rng.randn(B, 69) * 0.3).astype(np.float32)
    glob = (rng.randn(B, 3) * 0.3).astype(np.float32)
    pose[0, :3] = 0.0                       # the zero-rotation branch
    mean = (rng.randn(10) * 0.1).astype(np.float32)
    cfg = SmplAugmentConfig(delta_betas_distribution=dist if dist != "off" else "normal")
    params = {"augment_shape": dist != "off",
              "delta_betas_distribution": cfg.delta_betas_distribution,
              "delta_betas_std_vector": np.full(10, cfg.delta_betas_std, np.float32),
              "delta_betas_range": cfg.delta_betas_range}
    want = JA.augment_smpl(_key(1), jnp.asarray(orig), jnp.asarray(pose), jnp.asarray(glob),
                           jnp.asarray(mean), params)
    if cfg.delta_betas_distribution == "normal":
        draw = jax.random.normal(_key(1), (B, 10))
    else:
        draw = jax.random.uniform(_key(1), (B, 10), minval=-3.0, maxval=3.0)
    got = TSA.augment_smpl(torch.tensor(np.asarray(draw)), torch.as_tensor(orig),
                           torch.as_tensor(pose), torch.as_tensor(glob),
                           torch.as_tensor(mean), cfg, augment_shape=dist != "off")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    if dist == "off":
        np.testing.assert_array_equal(got[0].numpy(), orig)


def test_augment_cam_t():
    mean = np.tile(np.array([[0.0, 0.2, 42.0]], np.float32), (B, 1))
    want = JA.augment_cam_t(_key(2), jnp.asarray(mean), xy_std=0.05, delta_z_range=(-5.0, 5.0))
    kxy, kz = jax.random.split(_key(2))
    got = TCA.augment_cam_t(torch.as_tensor(mean),
                            torch.tensor(np.asarray(jax.random.normal(kxy, (B, 2)))),
                            torch.tensor(np.asarray(jax.random.uniform(
                                kz, (B,), minval=-5.0, maxval=5.0))), xy_std=0.05)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert ((got[:, 2] >= 37.0) & (got[:, 2] <= 47.0)).all()


def test_vertex_and_joint_deviation():
    rng = np.random.RandomState(3)
    verts = rng.randn(B, 50, 3).astype(np.float32)
    want = JA.random_verts2d_deviation(_key(3), jnp.asarray(verts), (-0.01, 0.01))
    noise = jax.random.uniform(_key(3), (B, 50, 2), minval=-0.01, maxval=0.01)
    got = TPA.random_verts2d_deviation(torch.as_tensor(verts), torch.tensor(np.asarray(noise)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_array_equal(got[..., 2].numpy(), verts[..., 2])

    joints = rng.uniform(0, 64, (B, 17, 2)).astype(np.float32)
    want = JA.random_joints2d_deviation(_key(4), jnp.asarray(joints), (-5.0, 5.0), (-15.0, 15.0))
    k1, k2 = jax.random.split(_key(4))
    got = TPA.random_joints2d_deviation(
        torch.as_tensor(joints),
        torch.tensor(np.asarray(jax.random.uniform(k1, (B, 17, 2), minval=-5.0, maxval=5.0))),
        torch.tensor(np.asarray(jax.random.uniform(k2, (B, 17, 2), minval=-15.0,
                                                      maxval=15.0))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _part_maps(seed, b=16, h=40, w=56):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 7, (b, h, w)).astype(np.float32)


def test_remove_bodyparts():
    seg = _part_maps(5)
    classes, probs = [1, 2, 3, 4, 5, 6], [0.1, 0.5, 0.1, 0.9, 0.05, 0.5]
    want = JA.random_remove_bodyparts(_key(5), jnp.asarray(seg), classes, probs)
    draws = np.stack([np.asarray(jax.random.uniform(k, (16,)))
                      for k in jax.random.split(_key(5), len(classes))])
    got = TPA.random_remove_bodyparts(torch.as_tensor(seg), classes, probs,
                                      torch.as_tensor(draws))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() != seg).any() and (got.numpy() == seg).any()


@pytest.mark.parametrize("h,w", [(64, 64), (40, 56)])
def test_occlude(h, w):
    seg = np.ones((16, h, w), np.float32)
    want = JA.random_occlude(_key(6), jnp.asarray(seg), occlude_probability=0.5,
                             occlude_box_dim=12)
    kc, kp = jax.random.split(_key(6))
    lo, hi = TPA.occlude_centre_range(h, w)
    centre = jax.random.uniform(kc, (16, 2), minval=jnp.asarray(lo), maxval=jnp.asarray(hi))
    got = TPA.random_occlude(torch.as_tensor(seg), torch.tensor(np.asarray(centre)),
                             torch.tensor(np.asarray(jax.random.uniform(kp, (16,)))),
                             occlude_probability=0.5, occlude_box_dim=12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    holes = (got.numpy() == 0).sum(axis=(1, 2))
    assert (holes == 0).any() and (holes == 144).any()


def test_augment_proxy_representation():
    cfg = TrainConfig(img_wh=IMG)
    seg = _part_maps(7, b=B, h=IMG, w=IMG)
    joints = np.random.RandomState(7).uniform(0, IMG, (B, 17, 2)).astype(np.float32)
    pa = cfg.proxy_augment
    params = {"remove_appendages": True,
              "remove_appendages_classes": list(pa.remove_appendages_classes),
              "remove_appendages_probabilities": list(pa.remove_appendages_probabilities),
              "occlude_seg": True, "occlude_probability": pa.occlude_probability,
              "occlude_box_dim": pa.occlude_box_dim, "deviate_joints2D": True,
              "delta_j2d_dev_range": pa.delta_j2d_dev_range,
              "delta_j2d_hip_dev_range": pa.delta_j2d_hip_dev_range}
    key = _key(8)
    jkeys = jax.random.split(key, 6)
    want_seg, want_j = JA.augment_proxy_representation(jkeys[5], jnp.asarray(seg),
                                                       jnp.asarray(joints), params)
    draws = jax_draws(key, B, 10, cfg).proxy
    got_seg, got_j = TPA.augment_proxy_representation(torch.as_tensor(seg),
                                                      torch.as_tensor(joints), draws, pa)
    np.testing.assert_array_equal(got_seg.numpy(), np.asarray(want_seg))
    np.testing.assert_allclose(got_j.numpy(), np.asarray(want_j), atol=ATOL)
    off = ProxyAugmentConfig(remove_appendages=False, occlude_seg=False, deviate_joints2D=False)
    same_seg, same_j = TPA.augment_proxy_representation(torch.as_tensor(seg),
                                                        torch.as_tensor(joints), draws, off)
    np.testing.assert_array_equal(same_seg.numpy(), seg)
    np.testing.assert_array_equal(same_j.numpy(), joints)


def _crop_inputs(seed):
    rng = np.random.RandomState(seed)
    segs = np.zeros((5, 64, 72), np.float32)
    segs[0, 10:50, 20:40] = 3.0                 # inside the image
    segs[1, 0:60, 50:72] = 2.0                  # the box leaves the image
    segs[2, 30:31, 7:8] = 1.0                   # one pixel
    segs[3] = rng.randint(0, 7, (64, 72)) * (rng.rand(64, 72) > 0.97)
    segs[4, 2:62, 2:70] = 6.0                   # nearly the whole image
    joints = rng.uniform(-10, 80, (5, 17, 2)).astype(np.float32)
    sf = (1.2 + rng.uniform(-0.2, 0.2, 5)).astype(np.float32)
    co = rng.uniform(-5, 5, (5, 2)).astype(np.float32)
    return segs, joints, sf, co


@pytest.mark.parametrize("out_wh", [64, 37])
def test_batch_crop_and_resize(out_wh):
    segs, joints, sf, co = _crop_inputs(9)
    want_seg, want_j = JB.batch_crop_and_resize(jnp.asarray(segs), jnp.asarray(joints), out_wh,
                                                jnp.asarray(sf), jnp.asarray(co))
    got_seg, got_j = TB.batch_crop_and_resize(torch.as_tensor(segs), torch.as_tensor(joints),
                                              out_wh, torch.as_tensor(sf), torch.as_tensor(co))
    np.testing.assert_array_equal(got_seg.numpy(), np.asarray(want_seg))
    np.testing.assert_allclose(got_j.numpy(), np.asarray(want_j), atol=ATOL)
    corners = torch.stack(TB.square_bbox_corners(torch.as_tensor(segs), torch.as_tensor(sf),
                                                 torch.as_tensor(co)), dim=-1).numpy()
    want_corners = np.stack([np.asarray(JB.square_bbox_corners(jnp.asarray(s), f, jnp.asarray(c)))
                             for s, f, c in zip(segs, sf, co)])
    np.testing.assert_array_equal(corners, want_corners)
    assert (corners[:, :2] < 0).any()           # some boxes are clamped


def test_check_joints2d_visibility():
    joints = np.random.RandomState(10).uniform(-8, 72, (B, 17, 2)).astype(np.float32)
    joints[0, 0] = [0.0, 64.0]                  # both bounds are inclusive
    joints[0, 1] = [-1e-6, 3.0]
    got = TJ.check_joints2d_visibility(torch.as_tensor(joints), IMG).numpy()
    want = np.asarray(JJ.check_joints2d_visibility(jnp.asarray(joints), IMG))
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] and not got[0, 1] and not got.all()


def test_draw_synthetic_shapes_ranges_and_seed():
    cfg = TrainConfig(img_wh=IMG)
    draws = [TS.draw_synthetic(torch.Generator().manual_seed(s), 16, 100, cfg, "cpu")
             for s in (3, 3, 4)]
    want = jax_draws(_key(0), 16, 100, cfg)

    def flat(d):
        return list(d[:-1]) + list(d.proxy)
    for x, y, z, v in zip(*map(flat, draws + [want])):
        assert x.shape == v.shape and x.dtype == v.dtype == torch.float32
        assert torch.equal(x, y) and not torch.equal(x, z)
    d = draws[0]
    assert d.cam_z.min() >= -5.0 and d.cam_z.max() < 5.0
    assert d.proxy.verts_noise.abs().max() <= 0.01
    assert d.proxy.occlude_centre.min() >= 0.35 * IMG and d.proxy.occlude_centre.max() < 0.65 * IMG
    assert 0.0 <= d.proxy.remove.min() and d.proxy.remove.max() < 1.0


@pytest.fixture(scope="module")
def both_assets():
    return load_synthetic_assets(), torch_assets(device="cpu")


def _spy(monkeypatch, module, store):
    """Record the pre-crop part maps, scale factors and centre offsets that
    `module.generate_synthetic_batch` hands to its crop."""
    real = module.batch_crop_and_resize

    def spy(parts, joints2d, img_wh, sf, co):
        store.update(parts=parts, sf=sf, co=co)
        return real(parts, joints2d, img_wh, sf, co)
    monkeypatch.setattr(module, "batch_crop_and_resize", spy)


@pytest.mark.parametrize("augment", [False, True], ids=["val", "train"])
def test_generate_synthetic_batch_vs_jax(both_assets, monkeypatch, augment):
    jassets, tassets = both_assets
    jcfg = JaxTrainConfig(img_wh=IMG, batch_size=B, focal_length=1250.0)
    jcfg.render.backend, jcfg.render.interpret = "pallas", True
    cfg = TrainConfig(img_wh=IMG, batch_size=B, focal_length=1250.0)
    rng = np.random.RandomState(11)
    pose = (rng.randn(B, 72) * 0.2).astype(np.float32)
    shape = (rng.randn(B, 10) * 0.5).astype(np.float32)
    key = _key(12)

    jstore, tstore = {}, {}
    _spy(monkeypatch, JS, jstore)
    _spy(monkeypatch, TS, tstore)

    def run(k, p, s):
        batch = JS.generate_synthetic_batch(k, p, s, jassets, jcfg, augment=augment)
        return batch, jstore["parts"], jstore["sf"], jstore["co"]
    want, jparts, jsf, jco = jax.jit(run)(key, jnp.asarray(pose), jnp.asarray(shape))
    draws = jax_draws(key, B, tassets.num_verts, cfg) if augment else None
    got = TS.generate_synthetic_batch(draws, torch.as_tensor(pose), torch.as_tensor(shape),
                                      tassets, cfg, augment=augment)

    jparts, tparts = np.asarray(jparts), tstore["parts"].numpy()
    assert (tparts > 0).mean() > 0.05
    assert ((tparts > 0) != (jparts > 0)).mean() < 0.002
    corners = torch.stack(TB.square_bbox_corners(tstore["parts"], tstore["sf"], tstore["co"]),
                          dim=-1).numpy()
    want_corners = np.stack([np.asarray(JB.square_bbox_corners(p, f, c))
                             for p, f, c in zip(jparts, np.asarray(jsf), np.asarray(jco))])
    np.testing.assert_array_equal(corners, want_corners)

    np.testing.assert_array_equal(got.target_vis.numpy(), np.asarray(want.target_vis))
    sil_t, sil_j = got.proxy[..., 0].numpy(), np.asarray(want.proxy)[..., 0]
    assert sil_t.mean() > 0.03
    assert (sil_t != sil_j).mean() < 0.002
    np.testing.assert_allclose(got.proxy[..., 1:].numpy(), np.asarray(want.proxy)[..., 1:],
                               atol=1e-5)
    for name in ("target_verts", "target_reposed_verts", "target_joints_h36mlsp",
                 "target_pose_rotmats", "target_shape"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=1e-5, err_msg=name)
    np.testing.assert_allclose(got.target_joints2d_coco.numpy(),
                               np.asarray(want.target_joints2d_coco), atol=1e-3)
    if augment:
        assert not np.allclose(np.asarray(want.target_shape), shape)
