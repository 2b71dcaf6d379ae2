"""The reference inference path: proxies from silhouettes and 2D joints
(the padded square crop and clean heatmaps), the regressor in evaluation
mode, SMPL on the predictions, the face-id renders, and the per-frame
metrics, in float32.
"""

import torch

from portbench.reference import body as Bm
from portbench.reference import raster
from portbench.reference import regressor as R
from portbench.reference import synth

VIS_FLIP_YZ = (1.0, -1.0, -1.0)
REPOSED_CAM_WP = (0.8, 0.0, -0.2)


def proxies(sils, joints, img_wh):
    seg, j = synth.padded_crop(sils, joints, img_wh)
    return synth.proxy((seg > 0).float(), j, img_wh)


@torch.no_grad()
def predict(prox, sd, body, depth, iters=3, fp8=False):
    init = R.initial_estimate(body["mean_pose_6d"], body["mean_shape"])
    cam, pose6d, shape = R.forward(prox, sd, depth, init, train=False, iters=iters, fp8=fp8)
    B = cam.shape[0]
    rot = Bm.rot6d_to_rotmat(pose6d.reshape(B, 24, 6))
    verts, joints = Bm.smpl(body, shape, rot[:, 1:], rot[:, 0:1])
    reposed, _ = Bm.smpl(body, shape)
    return {"cam_wp": cam, "shape": shape, "pose_rotmats": rot, "verts": verts,
            "reposed_verts": reposed, "joints3d_all": joints,
            "cam_t": Bm.wp_to_cam_t(cam, 5000.0, prox.shape[1])}


def vis_foreground(verts, cam_wp, body, img_wh, rotate_x180=False):
    """Where the vis render's face-id rasterisation covers a body: (B, H, W) bool."""
    verts = verts.float()
    if rotate_x180:
        verts = verts * torch.tensor(VIS_FLIP_YZ, device=verts.device)
    focal = 5000.0 * img_wh / 512.0
    K = Bm.intrinsics(img_wh, focal, verts.device)
    return raster.face_id_map(verts, Bm.wp_to_cam_t(cam_wp.float(), focal, img_wh), K,
                              body["faces"], img_wh) >= 0


def _procrustes(S1, S2):
    mu1, mu2 = S1.mean(1, keepdim=True), S2.mean(1, keepdim=True)
    X1, X2 = S1 - mu1, S2 - mu2
    var1 = torch.sum(X1 ** 2, dim=(1, 2))
    K = torch.einsum("bni,bnj->bij", X1, X2)
    U, _, Vh = torch.linalg.svd(K)
    V = Vh.transpose(-1, -2)
    Z = torch.eye(3, device=S1.device).repeat(K.shape[0], 1, 1)
    Z[:, -1, -1] = torch.sign(torch.linalg.det(torch.einsum("bij,bkj->bik", U, V)))
    Rm = torch.einsum("bij,bjk,blk->bil", V, Z, U)
    s = torch.einsum("bii->b", torch.einsum("bij,bjk->bik", Rm, K)) / var1
    t = mu2 - s[:, None, None] * torch.einsum("bij,bnj->bni", Rm, mu1)
    return s[:, None, None] * torch.einsum("bij,bnj->bni", Rm, S1) + t


def _scale_translate(P, T):
    Pt = P - P.mean(1, keepdim=True)
    Ps = torch.sqrt(torch.sum(Pt ** 2, dim=(1, 2), keepdim=True) / P.shape[1])
    Tm = T.mean(1, keepdim=True)
    Ts = torch.sqrt(torch.sum((T - Tm) ** 2, dim=(1, 2), keepdim=True) / T.shape[1])
    return Pt / Ps * Ts + Tm


_ALIGN = {"": lambda p, t: p, "_sc": _scale_translate, "_pa": _procrustes}


def per_frame_metrics(metrics, pred, target, pred_reposed, target_reposed, img_wh=None):
    """{metric: (B,)}: distances in metres (`_sc` scale and translation
    aligned, `_pa` Procrustes aligned), the rotation and shape mean
    squares, the 2D joints' mean distance in pixels (predictions in [-1, 1]),
    silhouette IoU with the summed counts."""
    out = {}
    pairs = {"pves": (pred["verts"], target["verts"]), "pve-ts": (pred_reposed, target_reposed),
             "mpjpes": (pred["joints3D"], target["joints3D"])}
    for base, (p, t) in pairs.items():
        for suffix, align in _ALIGN.items():
            if base + suffix in metrics:
                out[base + suffix] = torch.linalg.vector_norm(align(p, t) - t, dim=-1).mean(-1)
    if "pose_mses" in metrics:
        out["pose_mses"] = ((pred["rotmats"] - target["rotmats"]) ** 2).mean(dim=(1, 2, 3))
    if "shape_mses" in metrics:
        out["shape_mses"] = ((pred["shape"] - target["shape"]) ** 2).mean(dim=-1)
    if "joints2D_l2es" in metrics:
        out["joints2D_l2es"] = torch.linalg.vector_norm(
            Bm.to_pixels(pred["joints2D"], img_wh) - target["joints2D"], dim=-1).mean(-1)
    if "silhouette_ious" in metrics:
        ps, ts = pred["silhouettes"] != 0, target["silhouettes"] != 0
        tp = (ps & ts).sum(dim=(1, 2)).float()
        fp = (ps & ~ts).sum(dim=(1, 2)).float()
        fn = (~ps & ts).sum(dim=(1, 2)).float()
        out["silhouette_ious"] = tp / torch.clamp(tp + fp + fn, min=1.0)
        out["counts"] = torch.stack([tp.sum(), fp.sum(), fn.sum()])
    return out
