"""The PyTorch port's vis renders and PNG writer against the JAX package.

Same seeded numpy bodies and proxies into `straps_tpu.render.vis` and
`straps_tpu_torch.render.vis`:
* `lit_face_colors` within atol 1e-5 (float32 on both sides);
* `render_body_vis`, lit and parts, with and without `rotate_x180`: the JAX
  vis rasterises through `rasterize_xla` (plane order `(a*x + b*y) + c`),
  the port through the face-id rasteriser (`a*x + (b*y + c)`), so an edge
  pixel may take another face: such pixels stay below 0.2%; every other
  pixel is within 1 level of 255 (the uint8 cast truncates float32
  colours).  The parts style shades by depth gradients, which read the
  pixel's neighbours, so there the comparison leaves out the neighbours of
  pixels whose face differs;
* `proxy_vis` and the PNG writer, read back with `matplotlib.image.imread`:
  within 1 level of the file `plt.imsave` writes.
"""

import matplotlib.image as mpimg
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from straps_tpu.geometry import get_intrinsics_matrix, rodrigues
from straps_tpu.geometry import weak_perspective_to_camera_translation as jax_wp_to_t
from straps_tpu.render import raster as JR
from straps_tpu.render import vis as JV
from straps_tpu.smpl import load_synthetic_assets, smpl_forward
from straps_tpu_torch.render import vis as TV
from straps_tpu_torch.render.renderer import render_face_ids
from straps_tpu_torch.smpl.assets import load_synthetic_assets as torch_assets
from straps_tpu_torch.utils.png import encode_png, write_png
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

IMG = 64
CAMS = np.array([[0.9, 0.02, 0.1], [0.8, -0.05, 0.0]], np.float32)


@pytest.fixture(scope="module")
def bodies():
    """Two posed synthetic bodies (numpy, from the JAX SMPL) and both
    packages' assets."""
    assets = load_synthetic_assets()
    rng = np.random.RandomState(11)
    aa = jnp.asarray(rng.randn(2, 23, 3).astype(np.float32) * 0.25)
    glob = jnp.asarray(rng.randn(2, 1, 3).astype(np.float32) * 0.2)
    verts = smpl_forward(assets, jnp.asarray(rng.randn(2, 10).astype(np.float32) * 0.5),
                         rodrigues(aa), rodrigues(glob)).vertices
    return assets, torch_assets(device="cpu"), np.asarray(verts)


def _jax_face_ids(assets, verts, cam, rotate):
    """The face ids behind JAX `render_body_vis`: `rasterize_xla` of the
    body at the vis camera."""
    if rotate:
        verts = verts * np.asarray([1.0, -1.0, -1.0], np.float32)
    f = 5000.0 * IMG / 512.0
    cam_t = jax_wp_to_t(jnp.asarray(cam)[None], f, IMG)
    K = jnp.asarray(get_intrinsics_matrix(IMG, IMG, f))
    screen, z = JR.project_to_screen(jnp.asarray(verts)[None], cam_t, K)
    fid, _ = JR.rasterize_xla(JR.prepare_face_planes(screen, z, assets.faces).planes, IMG, IMG)
    return np.asarray(fid[0])


def _torch_face_ids(tassets, verts, cams, rotate):
    verts = torch.as_tensor(verts)
    if rotate:
        verts = verts * torch.tensor([1.0, -1.0, -1.0])
    cam_t, K = TV.vis_camera(torch.as_tensor(cams), IMG)
    return render_face_ids(verts, cam_t, K, tassets.faces, IMG)[0].numpy()


def _neighbours(mask):
    """`mask` grown by one pixel in each of the four directions."""
    out = mask.copy()
    out[1:] |= mask[:-1]
    out[:-1] |= mask[1:]
    out[:, 1:] |= mask[:, :-1]
    out[:, :-1] |= mask[:, 1:]
    return out


def test_lit_face_colors_vs_numpy(bodies):
    assets, tassets, verts = bodies
    got = TV.lit_face_colors(torch.as_tensor(verts), tassets.faces)
    assert got.shape == (2, np.asarray(assets.faces).shape[0], 3)
    for b in range(2):
        want = JV.lit_face_colors(verts[b], np.asarray(assets.faces))
        np.testing.assert_allclose(got[b].numpy(), want, atol=1e-5, rtol=0)
    assert got.min() >= 0.0 and got.max() <= 1.0


@pytest.mark.parametrize("style,rotate", [("lit", False), ("lit", True),
                                          ("parts", False), ("parts", True)])
def test_render_body_vis_vs_jax(bodies, style, rotate):
    assets, tassets, verts = bodies
    got = TV.render_body_vis_batch(torch.as_tensor(verts), torch.as_tensor(CAMS), tassets,
                                   img_wh=IMG, rotate_x180=rotate, style=style)
    assert got.shape == (2, IMG, IMG, 3) and got.dtype == torch.uint8
    fid_t = _torch_face_ids(tassets, verts, CAMS, rotate)
    for b in range(2):
        want = JV.render_body_vis(verts[b], CAMS[b], assets, img_wh=IMG,
                                  rotate_x180=rotate, style=style)
        fid_j = _jax_face_ids(assets, verts[b], CAMS[b], rotate)
        moved = fid_t[b] != fid_j
        assert (fid_j >= 0).mean() > 0.05 and moved.mean() < 0.002
        if style == "parts":
            moved = _neighbours(moved)
        diff = np.abs(got[b].numpy().astype(int) - want.astype(int)).max(-1)
        assert diff[~moved].max() <= 1, (b, np.argwhere(diff > 1)[:5])
        single = TV.render_body_vis(torch.as_tensor(verts[b]), torch.as_tensor(CAMS[b]),
                                    tassets, img_wh=IMG, rotate_x180=rotate, style=style)
        assert torch.equal(single, got[b])


@pytest.mark.parametrize("kind", ["rgb_uint8", "gray_float"])
def test_render_body_vis_composited_vs_jax(bodies, kind):
    assets, tassets, verts = bodies
    rng = np.random.RandomState(5)
    if kind == "rgb_uint8":
        image = rng.randint(0, 256, (IMG, IMG, 3)).astype(np.uint8)
    else:
        image = rng.rand(IMG, IMG).astype(np.float32)
    got = TV.render_body_vis(torch.as_tensor(verts[0]), torch.as_tensor(CAMS[0]), tassets,
                             img_wh=IMG, image=torch.as_tensor(image)).numpy()
    want = JV.render_body_vis(verts[0], CAMS[0], assets, img_wh=IMG, image=image)
    fid_t = _torch_face_ids(tassets, verts[:1], CAMS[:1], False)[0]
    fid_j = _jax_face_ids(assets, verts[0], CAMS[0], False)
    moved = fid_t != fid_j
    assert moved.mean() < 0.002
    bg = (fid_t < 0) & ~moved
    np.testing.assert_array_equal(got[bg], want[bg])
    assert np.abs(got.astype(int) - want.astype(int))[~moved].max() <= 1
    # An image of another size (a detector crop) is resized as cv2's float
    # INTER_LINEAR does before the composite: the background agrees with
    # the JAX vis to one level (cv2 rounds some float sums differently).
    small = image[5:45, 3:55] if kind == "rgb_uint8" else image[:IMG // 2, :IMG // 2]
    got = TV.render_body_vis(torch.as_tensor(verts[0]), torch.as_tensor(CAMS[0]), tassets,
                             img_wh=IMG, image=torch.as_tensor(small)).numpy()
    want = JV.render_body_vis(verts[0], CAMS[0], assets, img_wh=IMG, image=small)
    assert np.abs(got.astype(int) - want.astype(int))[bg].max() <= 1
    assert np.abs(got.astype(int) - want.astype(int))[~moved].max() <= 1


def test_shade_depth_matches_numpy():
    d = np.full((2, 24, 24), 3.4e38, np.float32)
    d[:, 6:18, 5:20] = np.linspace(40, 42, 15, dtype=np.float32)[None, None, :]
    d[1, 6:18, 5:20] += np.linspace(0, 1, 12, dtype=np.float32)[:, None]
    got = TV.shade_depth(torch.as_tensor(d)).numpy()
    for b in range(2):
        np.testing.assert_allclose(got[b], JV.shade_depth(d[b]), atol=1e-6)


@pytest.mark.parametrize("case", ["proxy", "offset", "flat"])
def test_proxy_vis_vs_jax(tmp_path, case):
    rng = np.random.RandomState(2)
    proxy = np.zeros((48, 40, 18), np.float32)
    if case != "flat":
        proxy[10:30, 8:28, 0] = 1.0
        proxy[..., 1:] = rng.rand(48, 40, 17).astype(np.float32) * 0.04
    if case == "offset":
        proxy[..., 0] = 0.0
        proxy[..., 1] += 0.1
    TV.proxy_vis(torch.as_tensor(proxy), str(tmp_path / "t.png"))
    JV.proxy_vis(proxy, str(tmp_path / "j.png"))
    got = mpimg.imread(str(tmp_path / "t.png"))
    want = mpimg.imread(str(tmp_path / "j.png"))
    assert got.shape == (48, 40) and want.shape == (48, 40, 4)
    assert np.abs(got - want[..., 0]).max() <= 1.0 / 255 + 1e-6
    batch = TV.proxy_vis_batch(torch.as_tensor(np.stack([proxy, proxy * 0.5])))
    np.testing.assert_array_equal(batch[0].numpy(), np.round(got * 255).astype(np.uint8))


@pytest.mark.parametrize("shape", [(5, 7), (5, 7, 3), (5, 7, 4), (1, 300, 3)])
def test_png_round_trip(tmp_path, shape):
    pixels = np.random.RandomState(0).randint(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "sub" / "a.png")
    write_png(path, pixels)
    back = mpimg.imread(path)
    assert back.shape == shape
    np.testing.assert_array_equal(np.round(back * 255).astype(np.uint8), pixels)


def test_png_rejects_bad_pixels():
    for bad in (np.zeros((4, 4), np.float32), np.zeros((4, 4, 2), np.uint8),
                np.zeros((4,), np.uint8), np.zeros((0, 4), np.uint8)):
        with pytest.raises(ValueError, match="PNG pixels"):
            encode_png(bad)


def test_vis_rejects_unknown_style(bodies):
    _, tassets, verts = bodies
    with pytest.raises(ValueError, match="unknown style"):
        TV.render_body_vis(torch.as_tensor(verts[0]), torch.as_tensor(CAMS[0]), tassets,
                           img_wh=IMG, style="wire")
