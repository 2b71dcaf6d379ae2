"""Offline evaluation harness (counterpart of
`straps_tpu/eval_harness/runner.py`).

Batched proxy construction -> prediction rollout -> metric math -> tracker
aggregation, with per-sample gendered body models for the ground truth and
silhouette IoU from re-rendering the predictions, in the proxy's crop frame
or, through the inverse crop, in the dataset's image frame.  When the
dataset ships neither silhouettes nor 2D joints, they are synthesised from
the GT parameters with the renderer (synthetic-eval mode).

On CUDA every render goes through the packed rasteriser kernel, one launch
per batch; on the CPU through its plain version, in sub-batches sized by
`gt_render_chunk_size`.  Back faces are culled in every render.  Over a
data mesh each rank synthesises, predicts and renders its rows of every
batch, and the per-frame metrics are gathered.
"""

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from straps_tpu_torch.config import PredictConfig
from straps_tpu_torch.eval_harness.datasets import normalise_gender
from straps_tpu_torch.geometry.camera import (
    get_intrinsics_matrix, perspective_project,
)
from straps_tpu_torch.metrics.compute import compute_per_frame_metrics
from straps_tpu_torch.metrics.eval_tracker import EvalMetricsTracker
from straps_tpu_torch.parallel.mesh import gather_batch, replicate, shard_batch
from straps_tpu_torch.predict.pipeline import (
    load_regressor_variables, make_predict_fn,
)
from straps_tpu_torch.predict.proxy import batch_silhouettes_joints_to_proxies
from straps_tpu_torch.render.renderer import render_silhouette
from straps_tpu_torch.smpl.assets import load_assets
from straps_tpu_torch.smpl.model import (
    select_joint_sets, smpl_forward, smpl_forward_axis_angle,
)
from straps_tpu_torch.utils.device import resolve_device
from straps_tpu_torch.utils.image import cv2_resize_nearest

def load_eval_npz(path: str) -> Dict[str, np.ndarray]:
    """A canonical eval npz (`poses`, `shapes`, optional others) as a dict;
    ValueError without both keys."""
    data = dict(np.load(path, allow_pickle=True))
    if "poses" not in data or "shapes" not in data:
        raise ValueError(f"eval npz needs poses/shapes; got {list(data)}")
    return data


DEFAULT_METRICS = ("pves", "pves_sc", "pves_pa", "pve-ts", "pve-ts_sc",
                   "mpjpes", "mpjpes_sc", "mpjpes_pa", "silhouette_ious")


def gt_render_chunk_size(img_wh: int) -> int:
    """Sub-batch of a render on the plain path, whose temporaries grow as
    (batch, 128 faces, rows, img_wh): the JAX package's memory model for its
    plain path (a 4.5 GB budget), kept for the CPU.  A CUDA render takes
    the whole batch."""
    return max(1, int(4.5e9 // (8 * 128 * img_wh * img_wh * 4)))


def _render_silhouettes(verts, cam_t, K, faces, img_wh) -> torch.Tensor:
    """Silhouettes of a batch, culled; sub-batched on the plain path."""
    if verts.device.type == "cuda":
        return render_silhouette(verts, cam_t, K, faces, img_wh,
                                 cull_backfaces=True)[0]
    ch = gt_render_chunk_size(img_wh)
    return torch.cat([
        render_silhouette(verts[s:s + ch], cam_t[s:s + ch], K, faces, img_wh,
                          cull_backfaces=True)[0]
        for s in range(0, verts.shape[0], ch)])


@torch.inference_mode()
def synthesise_proxy_inputs(poses: np.ndarray, shapes: np.ndarray, assets,
                            img_wh: int, focal_length: float = None,
                            cam_t=(0.0, 0.2, 42.0), chunk: int = 64
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Render GT meshes to silhouettes and project the GT COCO joints, on
    `assets`' device, `chunk` samples at a time (bounds the body-model
    memory).  Returns numpy (N, img_wh, img_wh) and (N, 17, 2)."""
    dev = assets.device
    if focal_length is None:
        # Reference convention: focal 5000 at 256 px, scaled with resolution.
        focal_length = 5000.0 * img_wh / 256.0
    K = torch.as_tensor(get_intrinsics_matrix(img_wh, img_wh, focal_length),
                        device=dev)
    eye = torch.eye(3, device=dev)
    sils, j2ds = [], []
    for s in range(0, poses.shape[0], chunk):
        po = torch.as_tensor(poses[s:s + chunk], device=dev)
        sh = torch.as_tensor(shapes[s:s + chunk], device=dev)
        t = torch.tensor(cam_t, dtype=torch.float32, device=dev).expand(po.shape[0], 3)
        out = smpl_forward_axis_angle(assets, sh, po)
        sils.append(_render_silhouettes(out.vertices, t, K, assets.faces, img_wh))
        _, coco = select_joint_sets(out.joints)
        j2ds.append(perspective_project(coco, eye, t, K))
    return torch.cat(sils).cpu().numpy(), torch.cat(j2ds).cpu().numpy()


def silhouette_crop_box(sil: np.ndarray, scale_factor: float = 1.2) -> Tuple[int, int, int, int]:
    """(top_r, top_c, crop_h, crop_w) of the square crop the proxy of this
    silhouette is built in: the bounding box's float32 corner arithmetic,
    truncated toward zero, as `geometry/bbox.py::square_bbox_corners`;
    (0, 0, 1, 1) for an empty silhouette."""
    sil = np.asarray(sil) > 0
    rows = np.flatnonzero(sil.any(axis=1))
    cols = np.flatnonzero(sil.any(axis=0))
    if len(rows) == 0 or len(cols) == 0:
        return 0, 0, 1, 1
    r0, r1 = int(rows[0]), int(rows[-1])
    c0, c1 = int(cols[0]), int(cols[-1])
    f32 = np.float32
    centre_r = f32(r0 + r1) / f32(2.0)
    centre_c = f32(c0 + c1) / f32(2.0)
    half = f32(max(r1 - r0, c1 - c0)) * f32(scale_factor) / f32(2.0)
    top_r, top_c = int(centre_r - half), int(centre_c - half)
    bot_r, bot_c = int(centre_r + half), int(centre_c + half)
    return top_r, top_c, max(bot_r - top_r, 1), max(bot_c - top_c, 1)


def paste_crop_to_image_frame(crop_sil: torch.Tensor, box, out_h: int,
                              out_w: int) -> torch.Tensor:
    """The inverse of the proxy crop: a crop-frame silhouette resized by
    nearest neighbour (cv2's INTER_NEAREST) to its (crop_h, crop_w) box and
    pasted, cut at the frame, into a zeroed float32 (out_h, out_w) canvas
    on its device."""
    top_r, top_c, ch, cw = box
    canvas = torch.zeros(out_h, out_w, dtype=torch.float32, device=crop_sil.device)
    resized = cv2_resize_nearest(crop_sil.to(torch.float32), cw, ch)
    r0, c0 = max(top_r, 0), max(top_c, 0)
    r1, c1 = min(top_r + ch, out_h), min(top_c + cw, out_w)
    if r1 > r0 and c1 > c0:
        canvas[r0:r1, c0:c1] = resized[r0 - top_r:r1 - top_r, c0 - top_c:c1 - top_c]
    return canvas


@torch.inference_mode()
def run_evaluation(dataset: Dict[str, np.ndarray], cfg: PredictConfig,
                   metrics=DEFAULT_METRICS, batch_size: int = 8,
                   save_per_frame: bool = False,
                   save_path: Optional[str] = None,
                   gender_assets: Optional[Dict] = None,
                   device="cuda", iou_frame: str = "crop", mesh=None) -> Dict[str, float]:
    """Evaluate a checkpoint on an eval dataset (`datasets.py`).

    Every sample is evaluated: the last partial batch is padded with
    repeats of the last sample and the padding is dropped before
    aggregation.  Ground truth goes through the per-sample gendered body
    model.  Silhouette IoU renders the predicted mesh with the
    weak-perspective camera the regressor emitted, in the crop frame the
    proxy was built in, and compares it, by `iou_frame`:
      - "crop": with the dataset silhouette put through the same crop
        (proxy channel 0);
      - "image": pasted back through the inverse crop
        (`paste_crop_to_image_frame`), with the dataset silhouette at its
        own resolution: the SSP-3D protocol the paper's mIoU is reported
        under.

    `mesh`: optional `parallel.DataMesh` (on its own device; its size
    must divide `batch_size`): each rank synthesises, predicts and renders
    its rows of every batch, the per-frame metrics are gathered, and every
    rank returns the global metrics; rank 0 alone saves the per-frame ones.
    """
    if iou_frame not in ("crop", "image"):
        raise ValueError(f"iou_frame must be 'crop' or 'image', got {iou_frame!r}")
    if mesh is not None and batch_size % mesh.size:
        raise ValueError(f"batch_size {batch_size} does not split over {mesh.size} ranks")
    dev = resolve_device(device) if mesh is None else mesh.device
    assets = load_assets(cfg.smpl_dir, device=dev)
    if gender_assets is None:
        gender_assets = {}
        if cfg.smpl_dir is not None:
            for g, name in (("m", "male"), ("f", "female")):
                try:
                    gender_assets[g] = load_assets(cfg.smpl_dir, gender=name,
                                                   device=dev)
                except (FileNotFoundError, OSError):
                    pass
    gender_assets = {g: ga.to(dev) for g, ga in gender_assets.items()}
    gender_assets.setdefault("n", assets)

    model, heatmap_mode = load_regressor_variables(cfg, assets, device=dev)
    if mesh is not None:
        replicate(model, mesh)
    predict = make_predict_fn(model, assets, cfg.img_wh,
                              input_dtype=cfg.proxy_input_dtype)

    poses = np.asarray(dataset["poses"], np.float32)
    shapes = np.asarray(dataset["shapes"], np.float32)
    genders = np.asarray([normalise_gender(g) for g in
                          dataset.get("genders", ["n"] * len(poses))])
    n = len(poses)
    # Every sample is evaluated: the last batch is padded with repeats of
    # the last sample; the padding is dropped before aggregation.
    idx_all = np.concatenate([np.arange(n),
                              np.full((-n) % batch_size, n - 1, np.int64)])
    batches = [idx_all[s:s + batch_size] for s in range(0, len(idx_all), batch_size)]
    if mesh is not None:
        batches = [shard_batch(idx, mesh) for idx in batches]
    have_sils = "silhouettes" in dataset
    have_j2d = "joints2D" in dataset
    if have_sils and have_j2d:
        sils = np.asarray(dataset["silhouettes"], np.float32)
        j2d = np.asarray(dataset["joints2D"], np.float32)[:, :, :2]
    elif not have_sils and not have_j2d:
        # The rows this process evaluates (over a mesh, this rank's rows),
        # in chunks of its share of a batch.
        rows = np.unique(np.concatenate(batches))
        row_sils, row_j2d = synthesise_proxy_inputs(poses[rows], shapes[rows], assets,
                                                    cfg.img_wh, chunk=len(batches[0]))
        sils = np.zeros((n,) + row_sils.shape[1:], np.float32)
        j2d = np.zeros((n,) + row_j2d.shape[1:], np.float32)
        sils[rows], j2d[rows] = row_sils, row_j2d
    else:
        # Proxies need silhouette and joints in the same image frame; a
        # synthetic stand-in for the missing one would live in another.
        missing = "joints2D" if have_sils else "silhouettes"
        raise ValueError(
            f"dataset ships {'silhouettes' if have_sils else 'joints2D'} "
            f"but no {missing}: the eval harness needs both annotations "
            f"(same image frame) or neither (fully synthetic GT).")

    img_wh = cfg.img_wh
    # The predicted cam_t uses focal 5000 at img_wh in the crop frame.
    K = torch.as_tensor(get_intrinsics_matrix(img_wh, img_wh, 5000.0), device=dev)
    want_iou = "silhouette_ious" in metrics
    lead = mesh is None or mesh.rank == 0
    tracker = EvalMetricsTracker(list(metrics), img_wh=img_wh,
                                 save_path=save_path if lead else None,
                                 save_per_frame_metrics=save_per_frame and lead)

    for b_i, idx in enumerate(batches):
        valid = min(batch_size, n - b_i * batch_size)
        proxies, _ = batch_silhouettes_joints_to_proxies(
            torch.as_tensor(sils[idx], device=dev),
            torch.as_tensor(j2d[idx], device=dev), img_wh,
            heatmap_mode=heatmap_mode)
        pred = predict(proxies)

        # Ground truth: the whole batch under each gender present, then the
        # rows of that gender.
        batch_g = genders[idx]
        sh_b = torch.as_tensor(shapes[idx], device=dev)
        po_b = torch.as_tensor(poses[idx], device=dev)
        gt_verts = gt_joints = gt_reposed = None
        for g in sorted(set(batch_g)):
            ga = gender_assets.get(g, gender_assets["n"])
            m = torch.as_tensor(batch_g == g, device=dev)
            o = smpl_forward_axis_angle(ga, sh_b, po_b)
            r = smpl_forward(ga, sh_b)
            if gt_verts is None:
                gt_verts, gt_joints = torch.zeros_like(o.vertices), torch.zeros_like(o.joints)
                gt_reposed = torch.zeros_like(r.vertices)
            gt_verts[m] = o.vertices[m]
            gt_joints[m] = o.joints[m]
            gt_reposed[m] = r.vertices[m]

        gt_h36mlsp, _ = select_joint_sets(gt_joints)
        pred_h36mlsp, _ = select_joint_sets(pred["joints3d_all"])
        pred_dict = {"verts": pred["verts"], "joints3D": pred_h36mlsp}
        target_dict = {"verts": gt_verts, "joints3D": gt_h36mlsp}
        if want_iou:
            pred_sil = _render_silhouettes(pred["verts"], pred["cam_t"], K, assets.faces,
                                           img_wh)
            if iou_frame == "image":
                img_h, img_w = sils.shape[1:3]
                pred_dict["silhouettes"] = torch.stack([
                    paste_crop_to_image_frame(pred_sil[b], silhouette_crop_box(sils[i]),
                                              img_h, img_w)
                    for b, i in enumerate(idx)])
                target_dict["silhouettes"] = torch.as_tensor(sils[idx], device=dev)
            else:
                pred_dict["silhouettes"] = pred_sil
                target_dict["silhouettes"] = proxies[..., 0]

        pf = compute_per_frame_metrics(tuple(metrics), pred_dict, target_dict,
                                       img_wh, pred_reposed=pred["reposed_verts"],
                                       target_reposed=gt_reposed)
        if mesh is not None:
            pf = gather_batch(pf, mesh)
        pf = {k: v.cpu().numpy() for k, v in pf.items()}
        tracker.update_per_batch({k: v[:valid] for k, v in pf.items()}, valid)
    return tracker.compute_final_metrics()
