"""The PyTorch port's rasterisers against the JAX package.

The plain versions of the kernels (`rasterize_packed` and
`rasterize_faceid` on CPU tensors) are held against the JAX Pallas kernels
run in interpret mode, with the bounds of `tests/test_render.py`: part map
and face ids exact on the two-triangle scene (depth rtol 1e-5), part
mismatch < 0.002 on the synthetic SMPL mesh (packed depth within 8 ulps).
Plane preparation and the chunk row bounds are held exactly; the plain
`rasterize_xla` exactly.  A float32 mirror of the CUDA kernels' per-row
span search (`csrc/raster_span.cuh`) is held to the plain versions' dense
coverage bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from straps_tpu.geometry import get_intrinsics_matrix
from straps_tpu.render import raster as JR
from straps_tpu.render import renderer as JRR
from straps_tpu.render.pallas_raster import rasterize_pallas
from straps_tpu.smpl import load_synthetic_assets, smpl_forward
from straps_tpu.geometry import rodrigues
from straps_tpu_torch.render import cuda_raster as CR
from straps_tpu_torch.render import raster as TR
from straps_tpu_torch.render import renderer as TRR
from raster_scenes import KERNEL_SCENES
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def make_triangle_scene():
    """Two overlapping triangles at different depths, in screen space."""
    screen = np.array([
        [8.0, 8.0], [56.0, 8.0], [8.0, 56.0],      # big triangle, far
        [20.0, 20.0], [44.0, 20.0], [20.0, 44.0],  # small triangle, near
    ], np.float32)
    z = np.array([10.0, 10.0, 10.0, 5.0, 5.0, 5.0], np.float32)
    faces = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    return screen, z, faces


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.fixture(scope="module")
def smpl_scenes():
    """(screen, z) of the synthetic mesh at 64x64: rest pose and a posed
    pair, as numpy from the JAX side."""
    assets = load_synthetic_assets()
    rng = np.random.RandomState(7)
    aa = jnp.asarray(rng.randn(2, 23, 3).astype(np.float32) * 0.3)
    glob = jnp.asarray(rng.randn(2, 1, 3).astype(np.float32) * 0.5)
    posed = smpl_forward(assets, jnp.zeros((2, 10)), rodrigues(aa), rodrigues(glob))
    verts = jnp.concatenate([assets.v_template[None], posed.vertices])
    cam_t = jnp.tile(jnp.asarray([[0.0, 0.2, 42.0]], jnp.float32), (3, 1))
    K = jnp.asarray(get_intrinsics_matrix(64, 64, 1250.0))
    screen, z = JR.project_to_screen(verts, cam_t, K)
    return assets, np.array(verts), np.array(cam_t), np.array(K), \
        np.array(screen), np.array(z)


def _jax_planes(screen, z, faces, cull):
    s, zz, f = jnp.asarray(screen), jnp.asarray(z), jnp.asarray(faces)
    planes = JR.prepare_face_planes(s, zz, f).planes
    dead = None
    if cull:
        dead = JR.backface_mask(s, f)
        planes = JR.kill_faces(planes, dead)
    return planes, JR.face_chunk_row_bounds(s, f, 128, 64, dead_mask=dead)


def _torch_planes(screen, z, faces, cull):
    s, zz, f = torch.as_tensor(screen), torch.as_tensor(z), torch.as_tensor(faces)
    planes = TR.prepare_face_planes(s, zz, f)
    dead = None
    if cull:
        dead = TR.backface_mask(s, f)
        planes = TR.kill_faces(planes, dead)
    return planes, TR.face_chunk_row_bounds(s, f, 128, 64, dead_mask=dead)


@pytest.mark.parametrize("cull", [False, True])
def test_planes_and_bounds_match(smpl_scenes, cull):
    assets, _, _, _, screen, z = smpl_scenes
    pj, bj = _jax_planes(screen, z, np.asarray(assets.faces), cull)
    pt, bt = _torch_planes(screen, z, np.asarray(assets.faces), cull)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))


def test_bounds_nan_guard():
    """A NaN face is left out of its chunk's band instead of emptying it."""
    screen, z, faces = make_triangle_scene()
    screen = np.concatenate([screen, [[np.nan, np.nan]] * 3]).astype(np.float32)
    faces = np.concatenate([faces, [[6, 7, 8]]]).astype(np.int32)
    want = JR.face_chunk_row_bounds(jnp.asarray(screen[None]), jnp.asarray(faces), 128, 64)
    got = TR.face_chunk_row_bounds(torch.as_tensor(screen[None]), torch.as_tensor(faces), 128, 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0, 0].tolist() == [8, 57]


def test_triangles_vs_pallas_interpret():
    screen, z, faces = make_triangle_scene()
    attr = np.array([3, 5], np.int32)
    pj, bj = _jax_planes(screen[None], z[None], faces, cull=False)
    parts_j, z_j = rasterize_pallas(pj, bj, 64, 64, interpret=True,
                                    face_attr=jnp.asarray(attr))
    pt, bt = _torch_planes(screen[None], z[None], faces, cull=False)
    parts_t, z_t = CR.rasterize_packed(pt, bt, torch.as_tensor(attr), 64, 64)
    parts_j, z_j = np.asarray(parts_j), np.asarray(z_j)
    assert set(np.unique(parts_j)) == {0, 3, 5}
    np.testing.assert_array_equal(parts_t.numpy(), parts_j)
    fg = parts_j > 0
    np.testing.assert_allclose(z_t.numpy()[fg], z_j[fg], rtol=1e-5)


@pytest.mark.parametrize("cull", [False, True])
def test_smpl_vs_pallas_interpret(smpl_scenes, cull):
    assets, _, _, _, screen, z = smpl_scenes
    faces = np.asarray(assets.faces)
    pj, bj = _jax_planes(screen, z, faces, cull)
    parts_j, z_j = rasterize_pallas(pj, bj, 64, 64, interpret=True,
                                    face_attr=assets.face_parts)
    pt, bt = _torch_planes(screen, z, faces, cull)
    parts_t, z_t = CR.rasterize_packed(pt, bt, torch.as_tensor(np.asarray(assets.face_parts)),
                                       64, 64)
    parts_j, z_j = np.asarray(parts_j), np.asarray(z_j)
    assert (parts_j > 0).mean() > 0.02 and len(np.unique(parts_j)) >= 3
    assert (parts_t.numpy() != parts_j).mean() < 0.002
    both = (parts_j > 0) & (parts_t.numpy() > 0)
    assert _ulps(z_t.numpy()[both], z_j[both]).max() <= 8


def test_rasterize_xla_face_ids_exact():
    screen, z, faces = make_triangle_scene()
    pj, _ = _jax_planes(screen[None], z[None], faces, cull=False)
    fid_j, z_j = JR.rasterize_xla(pj, 64, 64, chunk=2)
    fid_t, z_t = TR.rasterize_xla(torch.as_tensor(np.asarray(pj)), 64, 64, chunk=2)
    np.testing.assert_array_equal(fid_t.numpy(), np.asarray(fid_j))
    np.testing.assert_array_equal(z_t.numpy(), np.asarray(z_j))
    fparts = np.array([4, 6], np.int32)
    np.testing.assert_array_equal(
        TR.face_ids_to_parts(fid_t, torch.as_tensor(fparts)).numpy(),
        np.asarray(JR.face_ids_to_parts(fid_j, jnp.asarray(fparts))))


@pytest.mark.parametrize("cull", [False, True])
def test_render_silhouette_vs_jax(smpl_scenes, cull):
    assets, verts, cam_t, K, _, _ = smpl_scenes
    sil_j, _ = JRR.render_silhouette(jnp.asarray(verts), jnp.asarray(cam_t),
                                     jnp.asarray(K), assets.faces, 64,
                                     backend="pallas", interpret=True,
                                     cull_backfaces=cull)
    sil_t, _ = TRR.render_silhouette(torch.as_tensor(verts), torch.as_tensor(cam_t),
                                     torch.as_tensor(K),
                                     torch.as_tensor(np.asarray(assets.faces)), 64,
                                     cull_backfaces=cull)
    assert sil_t.dtype == torch.float32 and sil_t.shape == (3, 64, 64)
    assert (sil_t.numpy() != np.asarray(sil_j)).mean() < 0.002


def test_ragged_size_plain_matches_full_evaluation():
    """Any image size (no multiple-of-8 rule); the chunk-band skip of the
    plain version agrees with evaluating every chunk on every row."""
    screen, z, faces = make_triangle_scene()
    pt, _ = _torch_planes(screen[None], z[None], faces, cull=False)
    flat, attr = CR.pack_planes(pt, torch.tensor([1, 2]))
    tight = TR.face_chunk_row_bounds(torch.as_tensor(screen[None]),
                                     torch.as_tensor(faces), 128, 61)
    loose = torch.tensor([[[0, 61]]], dtype=torch.int32)
    got = CR.rasterize_packed_reference(flat, tight, attr, 61, 45)
    want = CR.rasterize_packed_reference(flat, loose, attr, 61, 45)
    assert got.shape == (1, 61, 45)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_kernel_wrapper_rejects_cpu_and_bad_inputs():
    flat = torch.zeros((1, 128, 12))
    bounds = torch.zeros((1, 1, 2), dtype=torch.int32)
    attr = torch.zeros((128,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        CR.packed_raster_kernel(flat, bounds, attr, 8, 8)
    with pytest.raises(ValueError, match="attr"):
        CR.packed_raster_kernel(flat, bounds, attr.long(), 8, 8)
    with pytest.raises(ValueError, match="bounds"):
        CR.packed_raster_kernel(flat, torch.zeros((1, 2, 2), dtype=torch.int32), attr, 8, 8)
    planes = torch.zeros((1, 2, 4, 3))
    for bad in ([0, 8], [-1, 3]):
        with pytest.raises(ValueError, match="face_attr"):
            CR.pack_planes(planes, torch.tensor(bad))
        with pytest.raises(ValueError, match="face_attr"):
            CR.rasterize_packed(planes, bounds, torch.tensor(bad), 8, 8)
    assert CR.packed_raster_kernel.launches == 0


def test_library_key_covers_included_headers(tmp_path):
    """A kernel library is rebuilt when a header of `csrc/` it includes,
    directly or not, changes; the kernels' own sources include the shared
    span header."""
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <stdint.h>\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    src = str(tmp_path / "k.cu")
    key = CR.source_digest(src)
    assert CR.source_digest(src) == key
    (tmp_path / "b.cuh").write_text("// b, changed\n")
    assert CR.source_digest(src) != key
    for kernel in CR.KERNELS:
        assert [p.rsplit("/", 1)[-1] for p in CR._local_includes(kernel.source)] == \
            [f"{kernel.name}.cu", "raster_span.cuh"]


def test_faceid_triangles_vs_pallas_interpret():
    screen, z, faces = make_triangle_scene()
    pj, bj = _jax_planes(screen[None], z[None], faces, cull=False)
    fid_j, z_j = rasterize_pallas(pj, bj, 64, 64, interpret=True)
    pt, bt = _torch_planes(screen[None], z[None], faces, cull=False)
    fid_t, z_t = CR.rasterize_faceid(pt, bt, 64, 64)
    fid_j, z_j = np.asarray(fid_j), np.asarray(z_j)
    assert set(np.unique(fid_j)) == {-1, 0, 1}
    np.testing.assert_array_equal(fid_t.numpy(), fid_j)
    fg = fid_j >= 0
    np.testing.assert_allclose(z_t.numpy()[fg], z_j[fg], rtol=1e-5)
    assert (z_t.numpy()[~fg] == np.float32(3.4e38)).all()
    assert (z_j[~fg] == np.float32(3.4e38)).all()


@pytest.mark.parametrize("cull", [False, True])
def test_faceid_smpl_vs_pallas_interpret(smpl_scenes, cull):
    assets, _, _, _, screen, z = smpl_scenes
    faces = np.asarray(assets.faces)
    fparts = np.asarray(assets.face_parts)
    pj, bj = _jax_planes(screen, z, faces, cull)
    fid_j, z_j = rasterize_pallas(pj, bj, 64, 64, interpret=True)
    pt, bt = _torch_planes(screen, z, faces, cull)
    fid_t, z_t = CR.rasterize_faceid(pt, bt, 64, 64)
    fid_j, z_j, fid_t, z_t = map(np.asarray, (fid_j, z_j, fid_t, z_t))
    parts_j = np.where(fid_j >= 0, fparts[np.maximum(fid_j, 0)], 0)
    parts_t = np.where(fid_t >= 0, fparts[np.maximum(fid_t, 0)], 0)
    assert (fid_j >= 0).mean() > 0.02 and len(np.unique(parts_j)) >= 3
    assert (parts_t != parts_j).mean() < 0.002
    same = (fid_t == fid_j) & (fid_j >= 0)
    np.testing.assert_allclose(z_t[same], z_j[same], rtol=1e-5)


def test_faceid_tie_takes_smallest_id_across_chunks():
    """Coplanar copies of one triangle at ids 5, 130 and 131 (chunks 0 and
    1) over a farther one at id 3: every pixel the near triangle covers
    takes id 5, as the TPU kernel's argmin-first within a chunk and strict
    `<` across chunks do."""
    screen, z, faces = make_triangle_scene()
    tri = np.asarray(JR.prepare_face_planes(jnp.asarray(screen[None]), jnp.asarray(z[None]),
                                            jnp.asarray(faces)).planes)[0]
    planes = np.zeros((1, 140, 4, 3), np.float32)
    planes[0, :, :3, 2] = -1.0                      # never covered
    planes[0, 3] = tri[0]                           # far big triangle
    planes[0, [5, 130, 131]] = tri[1]               # near small triangle
    bounds = np.tile(np.array([[[0, 64]]], np.int32), (1, 2, 1))
    fid_j, _ = rasterize_pallas(jnp.asarray(planes), jnp.asarray(bounds), 64, 64, interpret=True)
    fid_t, _ = CR.rasterize_faceid(torch.as_tensor(planes), torch.as_tensor(bounds), 64, 64)
    np.testing.assert_array_equal(fid_t.numpy(), np.asarray(fid_j))
    assert set(np.unique(fid_t.numpy())) == {-1, 3, 5}


def test_faceid_plain_sub_batches_and_ragged_size(monkeypatch):
    """The plain face-id version is the same in sub-batches, at any image
    size, and with its chunk-band skip as with every row evaluated."""
    screen, z, faces = make_triangle_scene()
    screens = np.stack([screen, screen + 3.0, screen - 2.0]).astype(np.float32)
    zs = np.stack([z, z * 2.0, z + 1.0]).astype(np.float32)
    pt, _ = _torch_planes(screens, zs, faces, cull=False)
    flat = CR.flatten_planes(pt)
    tight = TR.face_chunk_row_bounds(torch.as_tensor(screens), torch.as_tensor(faces), 128, 61)
    loose = torch.tensor([[[0, 61]]] * 3, dtype=torch.int32)
    fid, depth = CR.rasterize_faceid_reference(flat, tight, 61, 45)
    assert fid.shape == depth.shape == (3, 61, 45)
    fid_l, depth_l = CR.rasterize_faceid_reference(flat, loose, 61, 45)
    monkeypatch.setattr(CR, "_PLAIN_TEMP_BYTES", 128 * 61 * 45 * 4)   # one body per sub-batch
    fid_s, depth_s = CR.rasterize_faceid_reference(flat, tight, 61, 45)
    for f, d in ((fid_l, depth_l), (fid_s, depth_s)):
        np.testing.assert_array_equal(f.numpy(), fid.numpy())
        np.testing.assert_array_equal(d.numpy(), depth.numpy())


def test_packed_plain_sub_batches(monkeypatch):
    """The plain packed version gives the same keys in sub-batches (the
    size a B=140 training batch at 256² is compared in)."""
    screen, z, faces = make_triangle_scene()
    screens = np.stack([screen, screen + 3.0, screen - 2.0]).astype(np.float32)
    zs = np.stack([z, z * 2.0, z + 1.0]).astype(np.float32)
    pt, _ = _torch_planes(screens, zs, faces, cull=False)
    flat, attr = CR.pack_planes(pt, torch.tensor([1, 2]))
    bounds = TR.face_chunk_row_bounds(torch.as_tensor(screens), torch.as_tensor(faces), 128, 61)
    whole = CR.rasterize_packed_reference(flat, bounds, attr, 61, 45)
    monkeypatch.setattr(CR, "_PLAIN_TEMP_BYTES", 2 * 128 * 61 * 45 * 4)   # two bodies at a time
    np.testing.assert_array_equal(
        CR.rasterize_packed_reference(flat, bounds, attr, 61, 45).numpy(), whole.numpy())
    assert whole.shape == (3, 61, 45) and len(np.unique(whole.numpy() & 7)) == 3


def test_render_rgb_vs_jax(smpl_scenes):
    assets, verts, cam_t, K, _, _ = smpl_scenes
    colors = np.random.RandomState(3).rand(np.asarray(assets.faces).shape[0], 3).astype(np.float32)
    rgb_j, z_j = JRR.render_rgb(jnp.asarray(verts), jnp.asarray(cam_t), jnp.asarray(K),
                                assets.faces, jnp.asarray(colors), 64,
                                backend="pallas", interpret=True)
    faces_t = torch.as_tensor(np.asarray(assets.faces))
    args = (torch.as_tensor(verts), torch.as_tensor(cam_t), torch.as_tensor(K), faces_t)
    rgb_t, z_t = TRR.render_rgb(*args, torch.as_tensor(colors), 64)
    rgb_j, rgb_t = np.asarray(rgb_j), rgb_t.numpy()
    assert rgb_t.shape == (3, 64, 64, 3) and (rgb_j.sum(-1) > 0).mean() > 0.02
    assert (np.abs(rgb_t - rgb_j).max(-1) > 0).mean() < 0.002
    fg = np.asarray(z_j) < np.float32(3.4e38)
    np.testing.assert_allclose(z_t.numpy()[fg], np.asarray(z_j)[fg], rtol=1e-5)


def test_faceid_rasteriser_device_rule_and_wrapper_checks():
    flat = torch.zeros((1, 128, 12))
    bounds = torch.zeros((1, 1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        CR.faceid_raster_kernel(flat, bounds, 8, 8)
    with pytest.raises(ValueError, match="bounds"):
        CR.faceid_raster_kernel(flat, bounds.long(), 8, 8)
    with pytest.raises(ValueError, match="planes"):
        CR.faceid_raster_kernel(torch.zeros((1, 128, 12), dtype=torch.float64), bounds, 8, 8)
    with pytest.raises(ValueError, match="device meta"):
        CR.rasterize_faceid(torch.zeros((1, 2, 4, 3), device="meta"), bounds, 8, 8)
    assert CR.faceid_raster_kernel.launches == 0


# The kernels' span search (`csrc/raster_span.cuh`), mirrored in numpy
# float32 with each product and sum rounded on its own.  Its only caller is
# the test below.
_TILE_W = 256          # columns of one kernel block


def _passes(a, r, x):
    return (a * (x.astype(np.float32) + np.float32(0.5)) + r) >= 0


def _walk(s, step_while, delta):
    """Move each s by `delta` while `step_while(s)`: the kernel's
    neighbour steps, at most a tile's width of them."""
    for _ in range(_TILE_W + 1):
        step = step_while(s)
        if not step.any():
            return s
        s = s + delta * step
    raise AssertionError("walk longer than a tile")


def _clip_edge(a, r, k, m, est_shift=0.0):
    """`clip_edge` on arrays: narrow [k, m) to the pixels passing (a, r).
    The kernel's estimate is __fdividef(-r, a) (within 2 ulps); here the
    exact quotient, moved by `est_shift` pixels to show that the walk, not
    the estimate, decides the span."""
    with np.errstate(all="ignore"):
        est = (-r / a) - np.float32(0.5) + np.float32(est_shift)
        pos, neg = (a > 0) & (r == r), (a < 0) & (r == r)
        start = np.where(pos, np.ceil(est), np.floor(est) + np.float32(1.0))
        s = np.fmin(np.fmax(start, k), m).astype(np.int64)
        s = _walk(s, lambda s: pos & (s > k) & _passes(a, r, s - 1), -1)
        s = _walk(s, lambda s: pos & (s < m) & ~_passes(a, r, s), 1)
        s = _walk(s, lambda s: neg & (s < m) & _passes(a, r, s), 1)
        s = _walk(s, lambda s: neg & (s > k) & ~_passes(a, r, s - 1), -1)
        none = ~pos & ~neg & ~((a == 0) & (r >= 0))
    k2 = np.where(pos, s, k)
    m2 = np.where(neg, s, np.where(none, k2, m))
    return k2, m2


def _spans(p, img_h, img_w, est_shift):
    """(B, F, 12) planes -> [(x0, x1, k, m)] per x-tile, k and m (B, F, H):
    each face's covered span [k, m) of each row, found as the kernel
    finds it."""
    p = p.numpy()
    py = np.arange(img_h, dtype=np.float32)[None, None, :] + np.float32(0.5)
    tiles = []
    for x0 in range(0, img_w, _TILE_W):
        x1 = min(x0 + _TILE_W, img_w)
        k = np.full(p.shape[:2] + (img_h,), x0, np.int64)
        m = np.full_like(k, x1)
        for e in range(3):
            a = p[:, :, 3 * e, None]
            r = p[:, :, 3 * e + 1, None] * py + p[:, :, 3 * e + 2, None]
            live = k < m
            k2, m2 = _clip_edge(np.broadcast_to(a, r.shape), r, k, m, est_shift)
            k, m = np.where(live, k2, k), np.where(live, m2, m)
        tiles.append((x0, x1, k, m))
    return tiles


def _span_mask(tiles, faces):
    """The (B, C, H, W) coverage of the spans of faces `faces` (a slice)."""
    return np.concatenate([(np.arange(x0, x1) >= k[:, faces, :, None])
                           & (np.arange(x0, x1) < m[:, faces, :, None])
                           for x0, x1, k, m in tiles], axis=-1)


def _dense_coverage(p, img_h, img_w):
    """The plain versions' coverage of (B, C, 12) planes, every row."""
    xs = torch.arange(img_w, dtype=torch.float32) + 0.5
    y = (torch.arange(img_h, dtype=torch.float32) + 0.5)[:, None]
    e = [CR._plane_eval(p, k, xs, y) for k in (0, 3, 6)]
    return (torch.minimum(torch.minimum(e[0], e[1]), e[2]) >= 0).numpy()


_SPAN_SCENES = ["smpl culled", "smpl unculled", *KERNEL_SCENES]


@pytest.mark.parametrize("scene", _SPAN_SCENES)
def test_span_search_matches_dense_coverage(smpl_scenes, scene):
    """Each face's span per row, found from an estimate and exact steps,
    is exactly the set of pixels the dense evaluation covers: SMPL at 64²
    culled and unculled, triangles wider than 32 and 256 pixels across
    x-tiles, near-horizontal edges, vertices on pixel centres, a = +-0,
    dead faces, NaN and +-inf coefficients, ragged widths; with the
    estimate as the kernel makes it and 3.7 pixels off."""
    if scene.startswith("smpl"):
        assets, _, _, _, screen, z = smpl_scenes
        pt, _ = _torch_planes(screen, z, np.asarray(assets.faces), scene == "smpl culled")
        flat, img_h, img_w = CR.flatten_planes(pt), 64, 64
    else:
        flat, _, _, img_h, img_w = KERNEL_SCENES[scene]()
    spans = [_spans(flat, img_h, img_w, shift) for shift in (0.0, 3.7)]
    covered = 0
    for c0 in range(0, flat.shape[1], CR.FACE_CHUNK):
        faces = slice(c0, c0 + CR.FACE_CHUNK)
        want = _dense_coverage(flat[:, faces], img_h, img_w)
        covered += int(want.sum())
        for shift, tiles in zip((0.0, 3.7), spans):
            assert np.array_equal(_span_mask(tiles, faces), want), (c0, shift)
    assert covered > 0
