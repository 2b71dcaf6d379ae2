"""Plain rasterisers of the reference: part maps, silhouettes and face ids.

Frozen copies of the port's plain versions: each face as three edge planes
and a depth plane (`a*x + b*y + c`, each product and sum rounded on its
own) evaluated at the pixel centres of its chunk's row band, the nearest
covered face winning.  Part maps keep the port's packed key, the depth's
bits with the low three replaced by the part, so that ties resolve alike.
"""

import numpy as np
import torch

CHUNK = 128
BG_DEPTH = 3.4e38
ATTR_MASK = 7
PACKED_INIT = int(np.float32(BG_DEPTH).view(np.int32)) & ~ATTR_MASK
TEMP_BYTES = 1 << 28


def project(verts, cam_t, K):
    p = verts + cam_t[:, None, :]
    z = p[..., 2]
    x = K[0, 0] * p[..., 0] / z + K[0, 2]
    y = K[1, 1] * p[..., 1] / z + K[1, 2]
    return torch.stack([x, y], dim=-1), z


def _kill(dtype, device):
    k = torch.zeros((4, 3), dtype=dtype, device=device)
    k[:3, 2] = -1.0
    return k


def face_planes(screen, z, faces):
    v = screen[:, faces, :]
    zf = z[:, faces]
    x0, y0, x1, y1, x2, y2 = (v[..., 0, 0], v[..., 0, 1], v[..., 1, 0], v[..., 1, 1],
                              v[..., 2, 0], v[..., 2, 1])
    area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    s = torch.sign(area)

    def edge(ax, ay, bx, by):
        return torch.stack([-(by - ay) * s, (bx - ax) * s,
                            (ax * (by - ay) - ay * (bx - ax)) * s], dim=-1)

    z0, z1, z2 = zf[..., 0], zf[..., 1], zf[..., 2]
    nx = (y1 - y0) * (z2 - z0) - (z1 - z0) * (y2 - y0)
    ny = (z1 - z0) * (x2 - x0) - (x1 - x0) * (z2 - z0)
    safe = torch.where(area.abs() < 1e-9, torch.ones_like(area), area)
    zx, zy = -nx / safe, -ny / safe
    dplane = torch.stack([zx, zy, z0 - zx * x0 - zy * y0], dim=-1)
    planes = torch.stack([edge(x0, y0, x1, y1), edge(x1, y1, x2, y2), edge(x2, y2, x0, y0),
                          dplane], dim=-2)
    bad = (area.abs() < 1e-9) | torch.any(zf <= 1e-6, dim=-1)
    return torch.where(bad[..., None, None], _kill(planes.dtype, planes.device), planes), area


def row_bounds(screen, faces, img_h, dead=None):
    vy = screen[:, faces, 1]
    lo, hi = vy.amin(dim=-1), vy.amax(dim=-1)
    inf = torch.tensor(float("inf"), device=lo.device)
    lo = torch.where(torch.isnan(lo), inf, lo)
    hi = torch.where(torch.isnan(hi), -inf, hi)
    if dead is not None:
        lo, hi = torch.where(dead, inf, lo), torch.where(dead, -inf, hi)
    B, F = lo.shape
    pad = (-F) % CHUNK
    lo = torch.nn.functional.pad(lo, (0, pad), value=float("inf"))
    hi = torch.nn.functional.pad(hi, (0, pad), value=float("-inf"))
    lo = lo.reshape(B, -1, CHUNK).amin(-1)
    hi = hi.reshape(B, -1, CHUNK).amax(-1)
    return torch.stack([torch.clamp(torch.floor(lo), 0, img_h).to(torch.int32),
                        torch.clamp(torch.ceil(hi) + 1, 0, img_h).to(torch.int32)], -1)


def _flat(planes):
    B, F = planes.shape[:2]
    pad = (-F) % CHUNK
    if pad:
        planes = torch.cat([planes, _kill(planes.dtype, planes.device).expand(B, pad, 4, 3)], 1)
    return planes.reshape(B, planes.shape[1], 12).contiguous()


def _plane(p, k, xs, y):
    return p[:, :, k, None, None] * xs + (p[:, :, k + 1, None, None] * y
                                          + p[:, :, k + 2, None, None])


def _bands(bounds):
    lo = bounds[..., 0].amin(dim=0).tolist()
    hi = bounds[..., 1].amax(dim=0).tolist()
    return [(c, a, b) for c, (a, b) in enumerate(zip(lo, hi)) if a < b]


def _sub(bounds, img_wh, temp_bytes):
    """Bodies a sub-batch, so that a chunk's (bodies, faces, band rows,
    columns) temporaries stay under `temp_bytes`."""
    band = max(1, int((bounds[..., 1].amax(0) - bounds[..., 0].amin(0)).amax()))
    return max(1, temp_bytes // (CHUNK * band * img_wh * 4))


def packed_keys(flat, bounds, attr, img_wh, temp_bytes=TEMP_BYTES):
    B = flat.shape[0]
    sub = _sub(bounds, img_wh, temp_bytes)
    if B > sub:
        return torch.cat([packed_keys(flat[s:s + sub], bounds[s:s + sub], attr, img_wh,
                                      temp_bytes) for s in range(0, B, sub)])
    xs = torch.arange(img_wh, dtype=torch.float32, device=flat.device) + 0.5
    key = torch.full((B, img_wh, img_wh), PACKED_INIT, dtype=torch.int32, device=flat.device)
    for c, lo, hi in _bands(bounds):
        p = flat[:, c * CHUNK:(c + 1) * CHUNK]
        y = xs[lo:hi][:, None]
        cov = torch.minimum(torch.minimum(_plane(p, 0, xs, y), _plane(p, 3, xs, y)),
                            _plane(p, 6, xs, y)) >= 0
        zbits = _plane(p, 9, xs, y).view(torch.int32)
        pk = (zbits & ~ATTR_MASK) | attr[c * CHUNK:(c + 1) * CHUNK, None, None]
        pk = torch.where(cov, pk, PACKED_INIT).amin(dim=1)
        key[:, lo:hi] = torch.minimum(key[:, lo:hi], pk)
    return key


def face_ids(flat, bounds, img_wh):
    B = flat.shape[0]
    sub = _sub(bounds, img_wh, TEMP_BYTES)
    if B > sub:
        return torch.cat([face_ids(flat[s:s + sub], bounds[s:s + sub], img_wh)
                          for s in range(0, B, sub)])
    xs = torch.arange(img_wh, dtype=torch.float32, device=flat.device) + 0.5
    best_z = torch.full((B, img_wh, img_wh), BG_DEPTH, dtype=torch.float32, device=flat.device)
    best_f = torch.full((B, img_wh, img_wh), -1, dtype=torch.int32, device=flat.device)
    for c, lo, hi in _bands(bounds):
        p = flat[:, c * CHUNK:(c + 1) * CHUNK]
        y = xs[lo:hi][:, None]
        cov = torch.minimum(torch.minimum(_plane(p, 0, xs, y), _plane(p, 3, xs, y)),
                            _plane(p, 6, xs, y)) >= 0
        zed = torch.where(cov, _plane(p, 9, xs, y), BG_DEPTH)
        zmin = zed.amin(dim=1)
        amin = zed.argmin(dim=1).to(torch.int32) + c * CHUNK
        better = zmin < best_z[:, lo:hi]
        best_z[:, lo:hi] = torch.where(better, zmin, best_z[:, lo:hi])
        best_f[:, lo:hi] = torch.where(better, amin, best_f[:, lo:hi])
    return best_f


def part_map(verts, cam_t, K, faces, face_parts, img_wh, cull=True, temp_bytes=TEMP_BYTES):
    """(B, img_wh, img_wh) int32 part ids, 0 on the background; chunks are
    evaluated in sub-batches whose temporaries stay under `temp_bytes`."""
    screen, z = project(verts, cam_t, K)
    planes, area = face_planes(screen, z, faces)
    dead = None
    if cull:
        dead = area < 0.0
        planes = torch.where(dead[..., None, None], _kill(planes.dtype, planes.device), planes)
    flat = _flat(planes)
    attr = torch.zeros((flat.shape[1],), dtype=torch.int32, device=flat.device)
    attr[:face_parts.shape[0]] = face_parts.to(torch.int32)
    return packed_keys(flat, row_bounds(screen, faces, img_wh, dead), attr, img_wh,
                       temp_bytes) & ATTR_MASK


def silhouette(verts, cam_t, K, faces, img_wh, temp_bytes=TEMP_BYTES):
    ones = torch.ones((faces.shape[0],), dtype=torch.int32, device=faces.device)
    return (part_map(verts, cam_t, K, faces, ones, img_wh, temp_bytes=temp_bytes) > 0
            ).to(torch.float32)


def face_id_map(verts, cam_t, K, faces, img_wh):
    """(B, img_wh, img_wh) int32 nearest face ids, unculled, -1 on the background."""
    screen, z = project(verts, cam_t, K)
    planes, _ = face_planes(screen, z, faces)
    return face_ids(_flat(planes), row_bounds(screen, faces, img_wh), img_wh)
