"""Synthetic proxy-input generation of one training or validation step
(counterpart of `straps_tpu/train/synthetic.py`).

augment SMPL and camera -> SMPL forward -> perspective projection -> part
render (the packed rasteriser kernel on CUDA, back faces culled) -> jittered
bbox crop -> part removal, occlusion, joint noise -> heatmaps -> the
18-channel NHWC proxy, batched over the leading dimension and without
gradients.  The random draws of a step are one `SyntheticDraws`, made by
`draw_synthetic` from a `torch.Generator`; the validation path draws
nothing.  Over a data mesh every rank draws the global batch's draws from
the same seeded generator and keeps its rows (`shard_draws`).
"""

from typing import NamedTuple, Optional

import torch

from straps_tpu_torch.augment.cam_aug import augment_cam_t, draw_cam_jitter
from straps_tpu_torch.augment.draws import uniform
from straps_tpu_torch.augment.proxy_aug import (
    ProxyDraws, augment_proxy_representation, draw_proxy_augment,
    random_verts2d_deviation,
)
from straps_tpu_torch.augment.smpl_aug import augment_smpl, draw_delta_betas
from straps_tpu_torch.config import TrainConfig
from straps_tpu_torch.geometry.bbox import batch_crop_and_resize
from straps_tpu_torch.geometry.camera import get_intrinsics_matrix, perspective_project
from straps_tpu_torch.geometry.heatmaps import joints_to_gaussian_heatmaps
from straps_tpu_torch.geometry.joints import check_joints2d_visibility
from straps_tpu_torch.parallel.mesh import batch_rows
from straps_tpu_torch.render.renderer import render_part_seg
from straps_tpu_torch.smpl.assets import SmplAssets
from straps_tpu_torch.smpl.model import select_joint_sets, smpl_forward
from straps_tpu_torch.utils.profiling import span


class SyntheticBatch(NamedTuple):
    proxy: torch.Tensor                  # (B, H, W, 18) NHWC network input
    target_verts: torch.Tensor           # (B, V, 3)
    target_reposed_verts: torch.Tensor   # (B, V, 3)
    target_joints_h36mlsp: torch.Tensor  # (B, 14, 3)
    target_joints2d_coco: torch.Tensor   # (B, 17, 2) cropped-space pixels
    target_vis: torch.Tensor             # (B, 17) bool
    target_pose_rotmats: torch.Tensor    # (B, 24, 3, 3) root first
    target_shape: torch.Tensor           # (B, 10)


class SyntheticDraws(NamedTuple):
    """Every random draw of one augmented step, in the JAX package's key
    order: `split(key, 6)` -> [0] delta betas, [1] camera (xy, z), [2]
    vertex noise, [3] crop scale, [4] crop centre, [5] proxy degradations
    (part removal, occlusion, joint noise)."""
    delta_betas: torch.Tensor    # (B, 10) standard normal
    cam_xy: torch.Tensor         # (B, 2) standard normal
    cam_z: torch.Tensor          # (B,) in cam_augment.delta_z_range
    crop_scale: torch.Tensor     # (B,) in bbox_augment.delta_scale_range
    crop_centre: torch.Tensor    # (B, 2) in bbox_augment.delta_centre_range
    proxy: ProxyDraws            # vertex noise and the proxy degradations


def draw_synthetic(generator: torch.Generator, batch_size: int, num_verts: int,
                   cfg: TrainConfig, device) -> SyntheticDraws:
    """The draws of one augmented step from `generator` (which must live on
    `device`)."""
    B = batch_size
    with span("straps.train.draws"):
        betas = draw_delta_betas(generator, B, 10, cfg.smpl_augment, device)
        cam_xy, cam_z = draw_cam_jitter(generator, B, cfg.cam_augment, device)
        scale = uniform(generator, (B,), *cfg.bbox_augment.delta_scale_range, device)
        centre = uniform(generator, (B, 2), *cfg.bbox_augment.delta_centre_range, device)
        proxy = draw_proxy_augment(generator, B, num_verts, cfg.img_wh, cfg.img_wh,
                                   cfg.proxy_augment, device)
    return SyntheticDraws(betas, cam_xy, cam_z, scale, centre, proxy)


def shard_draws(draws: SyntheticDraws, mesh) -> SyntheticDraws:
    """This rank's rows (`parallel.batch_rows`) of a global batch's draws:
    the batch is axis 1 of `proxy.remove` (n_classes, B) and axis 0 of
    every other field."""
    rows = batch_rows(draws.cam_z.shape[0], mesh)
    proxy = type(draws.proxy)(*(v[:, rows] if k == "remove" else v[rows]
                                for k, v in draws.proxy._asdict().items()))
    return SyntheticDraws(*(v[rows] for v in draws[:-1]), proxy)


def build_proxy(seg: torch.Tensor, joints2d: torch.Tensor, img_wh: int,
                heatmap_mode: str = "clean") -> torch.Tensor:
    """Binary silhouette + 17 joint heatmaps -> (B, H, W, 18) NHWC proxy."""
    sil = (seg > 0).to(torch.float32)[..., None]
    hm = joints_to_gaussian_heatmaps(joints2d, img_wh, mode=heatmap_mode)   # (B, 17, H, W)
    return torch.cat([sil, hm.permute(0, 2, 3, 1)], dim=-1)


@torch.no_grad()
def generate_synthetic_batch(draws: Optional[SyntheticDraws], pose: torch.Tensor,
                             shape: torch.Tensor, assets: SmplAssets,
                             cfg: TrainConfig, augment: bool = True) -> SyntheticBatch:
    """One step's synthetic batch (train: `augment=True` with `draws`;
    validation: `augment=False`, no draws, the mean camera and crop).

    Args:
      pose: (B, 72) axis-angle SMPL pose, root first; shape: (B, 10) betas;
        both on `assets`' device.
    """
    with span("straps.train.synth"):
        with span("straps.synth.body"):
            B = pose.shape[0]
            dev = pose.device
            img_wh = cfg.img_wh
            mean_cam_t = torch.tensor(cfg.mean_cam_t, dtype=torch.float32,
                                      device=dev).expand(B, 3)
            cam_K = torch.as_tensor(get_intrinsics_matrix(img_wh, img_wh, cfg.focal_length),
                                    device=dev)
            mean_shape = torch.tensor(assets.mean_shape, dtype=torch.float32, device=dev)
            tgt_shape, tgt_pose_rm, tgt_glob_rm = augment_smpl(
                draws.delta_betas if augment else None, shape, pose[:, 3:], pose[:, :3],
                mean_shape, cfg.smpl_augment,
                augment_shape=cfg.smpl_augment.augment_shape and augment)
            if augment:
                cam_t = augment_cam_t(mean_cam_t, draws.cam_xy, draws.cam_z,
                                      xy_std=cfg.cam_augment.xy_std)
            else:
                cam_t = mean_cam_t

            out = smpl_forward(assets, tgt_shape, tgt_pose_rm, tgt_glob_rm)
            joints_h36mlsp, joints_coco = select_joint_sets(out.joints)
            eye = torch.eye(3, dtype=torch.float32, device=dev)
            joints2d = perspective_project(joints_coco, eye, cam_t, cam_K)
            reposed = smpl_forward(assets, tgt_shape)
            pose_rotmats = torch.cat([tgt_glob_rm, tgt_pose_rm], dim=1)

            verts_render = out.vertices
            if augment and cfg.proxy_augment.deviate_verts2D:
                verts_render = random_verts2d_deviation(out.vertices, draws.proxy.verts_noise)

        with span("straps.synth.render"):
            # Back faces culled: the part map is the same on the watertight
            # mesh, and the kernel skips chunks of back faces.
            parts, _ = render_part_seg(verts_render, cam_t, cam_K, assets.faces,
                                       assets.face_parts, img_wh, cull_backfaces=True)
            parts = parts.to(torch.float32)

        with span("straps.synth.proxy"):
            if cfg.bbox_augment.crop_input:
                if augment:
                    sf = cfg.bbox_augment.mean_scale_factor + draws.crop_scale
                    co = draws.crop_centre
                else:
                    sf = torch.full((B,), cfg.bbox_augment.mean_scale_factor,
                                    dtype=torch.float32, device=dev)
                    co = torch.zeros((B, 2), dtype=torch.float32, device=dev)
                parts, joints2d = batch_crop_and_resize(parts, joints2d, img_wh, sf, co)

            joints2d_input = joints2d
            if augment:
                parts, joints2d_input = augment_proxy_representation(
                    parts, joints2d, draws.proxy, cfg.proxy_augment)

            proxy = build_proxy(parts, joints2d_input, img_wh, heatmap_mode=cfg.heatmap_mode)
            vis = check_joints2d_visibility(joints2d, img_wh)
        return SyntheticBatch(
            proxy=proxy,
            target_verts=out.vertices,
            target_reposed_verts=reposed.vertices,
            target_joints_h36mlsp=joints_h36mlsp,
            target_joints2d_coco=joints2d,
            target_vis=vis,
            target_pose_rotmats=pose_rotmats,
            target_shape=tgt_shape,
        )
