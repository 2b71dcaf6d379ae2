"""Rasteriser scenes that stress the kernels' per-row span search, made
from a seed with numpy: triangles wider than a warp's 32 and a block's 256
columns that cross x-tile edges, ragged widths, near-horizontal edges,
vertices on pixel centres, edge planes with a == +-0, dead faces, NaN and
infinite coefficients, and a coplanar depth tie across two face chunks.

Each scene is (planes (B, Fp, 12) f32, bounds (B, Fp/128, 2) int32,
attributes (Fp,) int32 in [1, 8), img_h, img_w) as CPU tensors, ready for
`rasterize_packed_reference` / `rasterize_faceid_reference` or, moved to
the card, for the kernels.  Used by `tests/test_torch_raster.py` (the span
search against the dense coverage, on the CPU), `tests/test_torch_cuda.py`
and `chip_smoke.py` (kernels against their plain versions, on the card).
"""

import numpy as np
import torch

from straps_tpu_torch.render import cuda_raster as CR
from straps_tpu_torch.render import raster as TR


def _from_vertices(screen, z, img_h, rng):
    """(B, V, 2) screen vertices, three per face, and (B, V) depths ->
    planes, bounds and attributes of a scene."""
    screen = torch.as_tensor(np.asarray(screen, np.float32))
    z = torch.as_tensor(np.asarray(z, np.float32))
    faces = torch.arange(screen.shape[1], dtype=torch.int32).reshape(-1, 3)
    planes = TR.prepare_face_planes(screen, z, faces)
    bounds = TR.face_chunk_row_bounds(screen, faces, CR.FACE_CHUNK, img_h)
    flat = CR.flatten_planes(planes)
    attr = torch.as_tensor(rng.randint(1, 8, flat.shape[1]).astype(np.int32))
    return flat, bounds.contiguous(), attr


def _loose(flat, img_h, rng):
    """Bounds that put every chunk on every row, and random attributes."""
    B, Fp = flat.shape[:2]
    bounds = torch.tensor([0, img_h], dtype=torch.int32).repeat(B, Fp // CR.FACE_CHUNK, 1)
    attr = torch.as_tensor(rng.randint(1, 8, Fp).astype(np.int32))
    return flat, bounds.contiguous(), attr


def wide_triangles(img_h, img_w, seed, B=2):
    """Large triangles (tens to hundreds of pixels, many crossing the
    image's and the 256-column tiles' edges) over mid-sized ones."""
    rng = np.random.RandomState(seed)
    big = np.stack([rng.uniform(-0.15 * img_w, 1.15 * img_w, (B, 90, 3)),
                    rng.uniform(-0.2 * img_h, 1.2 * img_h, (B, 90, 3))], -1)
    centre = np.stack([rng.uniform(0, img_w, (B, 160, 1)), rng.uniform(0, img_h, (B, 160, 1))], -1)
    mid = centre + rng.uniform(-24, 24, (B, 160, 3, 2))
    screen = np.concatenate([big, mid], 1).reshape(B, -1, 2)
    z = rng.uniform(5.0, 50.0, screen.shape[:2])
    return (*_from_vertices(screen, z, img_h, rng), img_h, img_w)


def near_horizontal_edges(img_h, img_w, seed, B=2):
    """Triangles with an edge whose two ends differ in y by one to three
    float32 ulps, so |a| is ~1e-6 or less and the edge crosses a row far
    from where a coarse estimate would put it."""
    rng = np.random.RandomState(seed)
    n = 120
    y = rng.randint(1, img_h - 1, (B, n)).astype(np.float32) + np.float32(0.5)
    y += rng.choice([-1, 1], (B, n)) * rng.uniform(0, 0.3, (B, n)).astype(np.float32)
    y = y.astype(np.float32)
    y2 = y.copy()
    towards = np.where(rng.rand(B, n) < 0.5, np.float32(np.inf), np.float32(-np.inf))
    for i in range(3):          # one to three ulps up or down
        step = (rng.rand(B, n) < 0.6) | (i == 0)
        y2 = np.where(step, np.nextafter(y2, towards.astype(np.float32)), y2)
    xa = rng.uniform(-20, img_w + 20, (B, n))
    xb = rng.uniform(-20, img_w + 20, (B, n))
    apex = np.stack([rng.uniform(0, img_w, (B, n)),
                     y + rng.choice([-1, 1], (B, n)) * rng.uniform(2, img_h, (B, n))], -1)
    screen = np.stack([np.stack([xa, y], -1), np.stack([xb, y2], -1), apex], 2)
    screen = screen.astype(np.float32).reshape(B, -1, 2)
    z = rng.uniform(5.0, 50.0, screen.shape[:2])
    return (*_from_vertices(screen, z, img_h, rng), img_h, img_w)


def pixel_centre_vertices(img_h, img_w, seed, B=2):
    """Vertices on pixel centres, with axis-aligned right triangles among
    them: edge values exactly 0 on whole rows and columns, and a == +-0."""
    rng = np.random.RandomState(seed)
    n = 150
    corner = np.stack([rng.randint(0, img_w, (B, n)), rng.randint(0, img_h, (B, n))], -1) + 0.5
    dx = rng.randint(-40, 41, (B, n))
    dy = rng.randint(-30, 31, (B, n))
    right = np.stack([corner, corner + np.stack([dx, 0 * dy], -1),
                      corner + np.stack([0 * dx, dy], -1)], 2)
    free = np.stack([rng.randint(0, img_w, (B, n, 3)), rng.randint(0, img_h, (B, n, 3))],
                    -1) + 0.5
    screen = np.concatenate([right, free], 1).reshape(B, -1, 2)
    z = rng.uniform(5.0, 50.0, screen.shape[:2])
    return (*_from_vertices(screen, z, img_h, rng), img_h, img_w)


def special_planes(img_h, img_w, seed):
    """Edge planes written directly: a == +0.0 and -0.0 with r of either
    sign and +-0, dead faces (0, 0, -1), NaN and +-inf coefficients, and
    |a| ~ 1e-7 with the crossing inside the row.  The special edge sits in
    each of the three edge slots in turn, the other two are random
    half-planes through the image, so that faces of random depth win
    different pixels; loose bounds."""
    rng = np.random.RandomState(seed)
    inf, nan = np.float32(np.inf), np.float32(np.nan)
    edges = []
    for a in (0.0, -0.0):
        for b, c in ((0.0, 1.0), (0.0, -1.0), (0.0, 0.0), (0.0, -0.0), (1.0, -10.5),
                     (1.0, -10.500001), (-1.0, 10.5), (1e-30, 0.0)):
            edges.append((a, b, c))
    edges += [(0.0, 0.0, -1.0)] * 4
    for v in (nan, inf, -inf):
        edges += [(v, 0.0, 1.0), (v, 0.0, -1.0), (1.0, v, 1.0), (-1.0, v, 1.0),
                  (1.0, 0.0, v), (-1.0, 0.0, v), (v, v, v), (v, 1.0, -v)]
    for _ in range(40):
        a = np.float32(rng.choice([-1, 1]) * rng.uniform(0.5, 3.0) * 1e-7)
        target = np.float32(rng.uniform(-10, img_w + 10))
        edges.append((a, np.float32(rng.uniform(-1e-8, 1e-8)), -a * target))
    for _ in range(40):
        a = np.float32(rng.choice([-1, 1]) * 10.0 ** rng.uniform(-6, 4))
        edges.append((a, np.float32(rng.uniform(-3, 3)),
                      np.float32(-a * rng.uniform(0, img_w) - rng.uniform(-3, 3) * img_h / 2)))
    def half_plane():
        t = rng.uniform(0, 2 * np.pi)
        cx, cy = rng.uniform(0, img_w), rng.uniform(0, img_h)
        return np.cos(t), np.sin(t), -(np.cos(t) * cx + np.sin(t) * cy)

    planes = []
    for slot in range(3):
        for e in edges:
            rows = [half_plane(), half_plane(), half_plane(),
                    (rng.uniform(-0.01, 0.01), rng.uniform(-0.01, 0.01), rng.uniform(5.0, 50.0))]
            rows[slot] = e
            planes.append(rows)
    planes = torch.as_tensor(np.asarray(planes, np.float32))[None]      # (1, F, 4, 3)
    return (*_loose(CR.flatten_planes(planes), img_h, rng), img_h, img_w)


def coplanar_tie(seed=0):
    """Coplanar copies of one triangle at ids 5, 130 and 131 (chunks 0 and
    1) over a farther one at id 3, all else never covered; loose bounds.
    Every pixel the near triangle covers takes id 5."""
    rng = np.random.RandomState(seed)
    screen = torch.tensor([[[8.0, 8.0], [56.0, 8.0], [8.0, 56.0],
                            [20.0, 20.0], [44.0, 20.0], [20.0, 44.0]]])
    z = torch.tensor([[10.0, 10.0, 10.0, 5.0, 5.0, 5.0]])
    tri = TR.prepare_face_planes(screen, z, torch.tensor([[0, 1, 2], [3, 4, 5]]))[0]
    planes = torch.zeros((1, 140, 4, 3))
    planes[0, :, :3, 2] = -1.0
    planes[0, 3] = tri[0]
    planes[0, [5, 130, 131]] = tri[1]
    return (*_loose(CR.flatten_planes(planes), 64, rng), 64, 64)


KERNEL_SCENES = {
    "wide triangles 512x48": lambda: wide_triangles(48, 512, seed=11),
    "wide triangles 250x40": lambda: wide_triangles(40, 250, seed=12),
    "wide triangles 300x37": lambda: wide_triangles(37, 300, seed=13),
    "near-horizontal edges 512x40": lambda: near_horizontal_edges(40, 512, seed=14),
    "vertices on pixel centres 96x80": lambda: pixel_centre_vertices(80, 96, seed=15),
    "special planes 300x24": lambda: special_planes(24, 300, seed=16),
    "coplanar tie across chunks 64x64": coplanar_tie,
}
