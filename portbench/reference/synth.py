"""The reference's synthetic training batch: draws, SMPL and camera
augmentation, the part render, the jittered crop, the proxy degradations
and the 18-channel proxy.  Frozen copies of the port's plain formulas; the
random draws come from a `torch.Generator` in the same order as the
port's training loop draws them, so one seed gives both the same numbers.
`cfg` is the configuration file's dict (`configs/<name>.json`).
"""

import torch
import torch.nn.functional as F

from portbench.reference import body as Bm
from portbench.reference import raster


def _uniform(gen, shape, lo, hi, device):
    lo = torch.as_tensor(lo, dtype=torch.float32, device=device)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=device)
    return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo


def draws(gen, B, num_verts, cfg, device):
    """Every draw of one augmented step, in the training loop's order."""
    sa, ca, ba, pa = cfg["smpl_augment"], cfg["cam_augment"], cfg["bbox_augment"], \
        cfg["proxy_augment"]
    wh = cfg["img_wh"]
    d = {}
    if sa["delta_betas_distribution"] == "normal":
        d["betas"] = torch.randn((B, 10), generator=gen, device=device)
    else:
        d["betas"] = _uniform(gen, (B, 10), *sa["delta_betas_range"], device)
    d["cam_xy"] = torch.randn((B, 2), generator=gen, device=device)
    d["cam_z"] = _uniform(gen, (B,), *ca["delta_z_range"], device)
    d["scale"] = _uniform(gen, (B,), *ba["delta_scale_range"], device)
    d["centre"] = _uniform(gen, (B, 2), *ba["delta_centre_range"], device)
    d["verts_noise"] = _uniform(gen, (B, num_verts, 2), *pa["delta_verts2d_dev_range"], device)
    d["remove"] = torch.rand((len(pa["remove_appendages_classes"]), B), generator=gen,
                             device=device)
    lo = [wh / 2.0 - 0.3 * wh / 2.0] * 2
    hi = [wh / 2.0 + 0.3 * wh / 2.0] * 2
    d["occ_centre"] = _uniform(gen, (B, 2), lo, hi, device)
    d["occlude"] = torch.rand((B,), generator=gen, device=device)
    d["j_noise"] = _uniform(gen, (B, 17, 2), *pa["delta_j2d_dev_range"], device)
    d["hip_noise"] = _uniform(gen, (B, 17, 2), *pa["delta_j2d_hip_dev_range"], device)
    return d


def _bbox(seg):
    fg = seg != 0
    B, h, w = seg.shape
    rows, cols = fg.any(dim=2), fg.any(dim=1)
    ri = torch.arange(h, dtype=torch.int32, device=seg.device)
    ci = torch.arange(w, dtype=torch.int32, device=seg.device)
    big = 1 << 30
    r0 = torch.where(rows, ri, big).amin(1)
    r1 = torch.where(rows, ri, -big).amax(1)
    c0 = torch.where(cols, ci, big).amin(1)
    c1 = torch.where(cols, ci, -big).amax(1)
    empty = ~rows.any(1)
    zero = torch.zeros_like(r0)
    return tuple(torch.where(empty, zero, v) for v in (r0, r1, c0, c1))


def _corners(seg, scale, offset=None):
    r0, r1, c0, c1 = _bbox(seg)
    two = torch.tensor(2.0, device=seg.device)
    cr = (r0 + r1).to(torch.float32) / two
    cc = (c0 + c1).to(torch.float32) / two
    if offset is not None:
        cr, cc = cr + offset[:, 0], cc + offset[:, 1]
    half = torch.maximum((r1 - r0).to(torch.float32), (c1 - c0).to(torch.float32)) \
        * torch.as_tensor(scale, dtype=torch.float32, device=seg.device) / two
    return tuple(v.to(torch.int32) for v in (cr - half, cc - half, cr + half, cc + half))


def _resample(seg, r0, c0, ch, cw, out_wh):
    B, h, w = seg.shape
    ys = torch.arange(out_wh, dtype=torch.float32, device=seg.device)
    out = torch.full_like(ys, out_wh)
    sr = r0[:, None] + torch.floor(ys * ch.to(torch.float32)[:, None] / out).to(torch.int32)
    sc = c0[:, None] + torch.floor(ys * cw.to(torch.float32)[:, None] / out).to(torch.int32)
    valid = ((sr >= 0) & (sr < h))[:, :, None] & ((sc >= 0) & (sc < w))[:, None, :]
    b = torch.arange(B, device=seg.device)[:, None, None]
    picked = seg[b, sr.clamp(0, h - 1).long()[:, :, None], sc.clamp(0, w - 1).long()[:, None, :]]
    return torch.where(valid, picked, torch.zeros_like(picked))


def _scale_joints(joints, r0, c0, ch, cw, out_wh, device):
    shifted = joints - torch.stack([c0, r0], -1).to(torch.float32)[:, None, :]
    o = torch.tensor(float(out_wh), device=device)
    scale = torch.stack([o / cw.to(torch.float32), o / ch.to(torch.float32)], -1)
    return shifted * scale[:, None, :]


def train_crop(segs, joints, out_wh, scale, offset):
    h, w = segs.shape[1:]
    tr, tc, br, bc = (torch.clamp(v, min=0) for v in _corners(segs, scale, offset))
    ch = torch.clamp(torch.clamp(br, max=h) - tr, min=1)
    cw = torch.clamp(torch.clamp(bc, max=w) - tc, min=1)
    return (_resample(segs, tr, tc, ch, cw, out_wh),
            _scale_joints(joints, tr, tc, ch, cw, out_wh, segs.device))


def padded_crop(segs, joints, out_wh, scale=1.2):
    tr, tc, br, bc = _corners(segs, scale)
    ch, cw = torch.clamp(br - tr, min=1), torch.clamp(bc - tc, min=1)
    return (_resample(segs, tr, tc, ch, cw, out_wh),
            _scale_joints(joints, tr, tc, ch, cw, out_wh, segs.device))


def heatmaps(joints, img_wh, std=4.0):
    """Clean Gaussian heatmaps (B, J, img_wh, img_wh) around the truncated joints."""
    size = 2.0 * std
    c = joints.to(torch.int32).to(torch.float32)
    xs = torch.arange(img_wh, dtype=torch.float32, device=joints.device)
    dx, dy = xs - c[..., 0:1], xs - c[..., 1:2]
    gx = torch.exp(-(dx * dx) / (2.0 * std * std)) * (dx.abs() < size)
    gy = torch.exp(-(dy * dy) / (2.0 * std * std)) * (dy.abs() < size)
    inb = torch.all((c > -size) & (c < img_wh - 1 + size), dim=-1)
    return gy[:, :, :, None] * gx[:, :, None, :] * inb[:, :, None, None].to(torch.float32)


def proxy(seg, joints, img_wh):
    sil = (seg > 0).to(torch.float32)[..., None]
    return torch.cat([sil, heatmaps(joints, img_wh).permute(0, 2, 3, 1)], dim=-1)


@torch.no_grad()
def synthetic_batch(d, pose, shape, body, cfg):
    """One augmented step's batch: a dict of the proxy (B, H, W, 18) and the
    targets of the loss."""
    B, dev, wh = pose.shape[0], pose.device, cfg["img_wh"]
    sa, ba, pa = cfg["smpl_augment"], cfg["bbox_augment"], cfg["proxy_augment"]
    if sa["augment_shape"]:
        if sa["delta_betas_distribution"] == "uniform":
            shape = d["betas"] + body["mean_shape"]
        else:
            shape = d["betas"] * torch.full_like(body["mean_shape"], sa["delta_betas_std"]) \
                + body["mean_shape"]
    pose_rm = Bm.rodrigues(pose[:, 3:].reshape(B, 23, 3))
    glob_rm = Bm.rodrigues(pose[:, :3].reshape(B, 1, 3))
    mean_t = torch.tensor(cfg["mean_cam_t"], dtype=torch.float32, device=dev).expand(B, 3)
    cam_t = torch.cat([mean_t[:, :2] + d["cam_xy"] * cfg["cam_augment"]["xy_std"],
                       (mean_t[:, 2] + d["cam_z"])[:, None]], dim=1)
    K = Bm.intrinsics(wh, cfg["focal_length"], dev)
    verts, joints = Bm.smpl(body, shape, pose_rm, glob_rm)
    j14, coco = Bm.joint_sets(joints)
    joints2d = Bm.perspective(coco, cam_t, K)
    reposed, _ = Bm.smpl(body, shape)
    vr = verts
    if pa["deviate_verts2D"]:
        vr = torch.cat([verts[..., :2] + d["verts_noise"], verts[..., 2:]], dim=-1)
    parts = raster.part_map(vr, cam_t, K, body["faces"], body["face_parts"], wh).float()
    if ba["crop_input"]:
        parts, joints2d = train_crop(parts, joints2d, wh, ba["mean_scale_factor"] + d["scale"],
                                     d["centre"])
    joints_in = joints2d
    if pa["remove_appendages"]:
        for u, cls, prob in zip(d["remove"], pa["remove_appendages_classes"],
                                pa["remove_appendages_probabilities"]):
            parts = torch.where((u < prob)[:, None, None] & (parts == cls),
                                torch.zeros_like(parts), parts)
    if pa["occlude_seg"]:
        half = pa["occlude_box_dim"] / 2.0
        cen = d["occ_centre"]
        r0, r1 = (cen[:, 0] - half).to(torch.int32), (cen[:, 0] + half).to(torch.int32)
        c0, c1 = (cen[:, 1] - half).to(torch.int32), (cen[:, 1] + half).to(torch.int32)
        rows = torch.arange(wh, device=dev)[None, :, None]
        cols = torch.arange(wh, device=dev)[None, None, :]
        box = ((rows >= r0[:, None, None]) & (rows < r1[:, None, None])
               & (cols >= c0[:, None, None]) & (cols < c1[:, None, None]))
        hit = box & (d["occlude"] < pa["occlude_probability"])[:, None, None]
        parts = torch.where(hit, torch.zeros_like(parts), parts)
    if pa["deviate_joints2D"]:
        hip = torch.zeros(17, dtype=torch.bool, device=dev)
        hip[Bm.COCO_HIPS] = True
        joints_in = joints2d + torch.where(hip[None, :, None], d["hip_noise"], d["j_noise"])
    return {"proxy": proxy(parts, joints_in, wh), "verts": verts, "reposed": reposed,
            "joints3D": j14, "joints2D": joints2d,
            "vis": ((joints2d >= 0) & (joints2d <= wh)).all(dim=-1),
            "rotmats": torch.cat([glob_rm, pose_rm], dim=1), "shape": shape}


def silhouette_target(proxy_, wh):
    return F.interpolate(proxy_[..., 0][:, None], (wh, wh), mode="bilinear", antialias=True,
                         align_corners=False)[:, 0]
