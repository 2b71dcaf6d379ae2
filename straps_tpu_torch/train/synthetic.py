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

On the card the batch, from the SMPL body to the proxy, is two CUDA
graphs (`utils/native_build.py::KernelGraph`) for each key
(`generate_synthetic_batch`), held by the `SmplAssets` it reads, with the
packed rasteriser's launch between them; the draws stay eager, as they
follow the caller's generator.  `SYNTH_GRAPH_STATS` counts the captures,
the replays and the eager calls by reason.
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
from straps_tpu_torch.render import cuda_raster as CR
from straps_tpu_torch.render.renderer import part_seg_planes, render_part_seg
from straps_tpu_torch.smpl.assets import SmplAssets
from straps_tpu_torch.smpl.model import select_joint_sets, smpl_forward
from straps_tpu_torch.utils.device import device_constant
from straps_tpu_torch.utils.native_build import KernelGraph, KeyedGraphs
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


# The calls of `generate_synthetic_batch` since the last reset, each
# counted once: captured (and replayed), replayed, or eager by reason (CPU
# tensors; the first call of its key).
SYNTH_GRAPH_STATS = KeyedGraphs("first_of_key", "cpu")


def reset_synth_graph_stats() -> None:
    """Zero every count of `SYNTH_GRAPH_STATS`."""
    SYNTH_GRAPH_STATS.reset()


@torch.no_grad()
def generate_synthetic_batch(draws: Optional[SyntheticDraws], pose: torch.Tensor,
                             shape: torch.Tensor, assets: SmplAssets,
                             cfg: TrainConfig, augment: bool = True) -> SyntheticBatch:
    """One step's synthetic batch (train: `augment=True` with `draws`;
    validation: `augment=False`, no draws, the mean camera and crop).

    On the card the batch is CUDA graphs for each key (`_graph_key`: the
    device, the inputs' shapes, strides and dtypes, `augment` and the
    configuration it reads), kept in `assets.synth_graphs`: a key's first
    call runs eagerly, its second is captured and replayed, every later one
    copies `pose`, `shape` and the draws into the graph's inputs and
    replays it (`_SynthGraph`).  The replay's outputs are the graph's own
    tensors, valid until the next call of the same key.  CPU tensors run
    eagerly.  The arithmetic is the eager batch's either way.

    Args:
      pose: (B, 72) axis-angle SMPL pose, root first; shape: (B, 10) betas;
        both on `assets`' device.
    """
    with span("straps.train.synth"):
        def eager():
            return _eager_batch(draws, pose, shape, assets, cfg, augment)
        if not pose.is_cuda:
            return SYNTH_GRAPH_STATS.run_eager("cpu", eager)
        inputs = _graph_inputs(draws, pose, shape, augment)
        return SYNTH_GRAPH_STATS.call(
            assets.synth_graphs, _graph_key(inputs, cfg, augment),
            capture=lambda: _SynthGraph(inputs, assets, cfg, augment),
            replay=lambda graph: graph.replay(inputs), eager=eager)


# The fields of `SyntheticDraws` that are tensors; `proxy` holds the rest.
_TENSOR_DRAWS = tuple(f for f in SyntheticDraws._fields if f != "proxy")


def _graph_inputs(draws: Optional[SyntheticDraws], pose: torch.Tensor, shape: torch.Tensor,
                  augment: bool) -> tuple:
    """The tensors the batch reads: `pose`, `shape`, then, when it
    augments, every draw (`_TENSOR_DRAWS`, then the fields of `proxy`)."""
    if not augment:
        return pose, shape
    return (pose, shape, *(getattr(draws, f) for f in _TENSOR_DRAWS), *draws.proxy)


def _from_inputs(inputs: tuple, augment: bool):
    """(draws or None, pose, shape) of `_graph_inputs`' tuple."""
    pose, shape, *rest = inputs
    if not augment:
        return None, pose, shape
    n = len(_TENSOR_DRAWS)
    draws = SyntheticDraws(**dict(zip(_TENSOR_DRAWS, rest[:n])), proxy=ProxyDraws(*rest[n:]))
    return draws, pose, shape


def _graph_key(inputs: tuple, cfg: TrainConfig, augment: bool) -> tuple:
    """What a captured batch depends on beyond the values of its inputs
    and the assets that hold it."""
    return (inputs[0].device, tuple((tuple(t.shape), t.stride(), t.dtype) for t in inputs),
            augment, cfg.img_wh, cfg.focal_length, tuple(cfg.mean_cam_t), cfg.heatmap_mode,
            repr(cfg.smpl_augment), repr(cfg.cam_augment), repr(cfg.bbox_augment),
            repr(cfg.proxy_augment))


class _SynthGraph:
    """One key's synthetic batch as two graphs, captured on a side stream,
    around the packed rasteriser's launch: the first from the inputs to
    the kernel's arguments, the second from its keys to the batch.  The
    launch runs between the replays, through `cuda_raster.
    packed_raster_kernel` as an eager batch's does, so that what records
    or counts the kernel's launches sees it at every call.  The inputs are
    a copy of those the graphs were captured with; the body the second
    graph reads, the kernel's arguments, its keys' copy and the outputs
    are kept, so their memory stays the graphs' from replay to replay."""

    def __init__(self, inputs: tuple, assets: SmplAssets, cfg: TrainConfig, augment: bool):
        self.inputs = tuple(t.clone() for t in inputs)
        draws, pose, shape = _from_inputs(self.inputs, augment)
        self.before, self.after = KernelGraph(), KernelGraph()
        with self.before.capture():
            self.body = _body(draws, pose, shape, assets, cfg, augment)
            planes, bounds = _part_seg_planes(self.body, assets, cfg)
            flat, attr = CR.pack_planes(planes, assets.face_parts)
            self.raster_args = (flat, bounds.to(torch.int32).contiguous(), attr,
                                cfg.img_wh, cfg.img_wh)
        self.keys = torch.empty((pose.shape[0], cfg.img_wh, cfg.img_wh), dtype=torch.int32,
                                device=pose.device)
        with self.after.capture():
            parts = CR.unpack_keys(self.keys)[0].to(torch.float32)
            self.batch = _proxy_batch(self.body, parts, draws, cfg, augment)

    def replay(self, inputs: tuple) -> SyntheticBatch:
        """`inputs` into the graphs' inputs, then the replays around the launch."""
        for dst, src in zip(self.inputs, inputs):
            dst.copy_(src)
        self.before.replay()
        self.keys.copy_(CR.packed_raster_kernel(*self.raster_args))
        self.after.replay()
        return self.batch


class _Body(NamedTuple):
    """What the synthetic batch's body stage hands the render and the proxy."""
    vertices: torch.Tensor         # (B, V, 3) posed target mesh
    reposed: torch.Tensor          # (B, V, 3) in the rest pose
    joints_h36mlsp: torch.Tensor   # (B, 14, 3)
    joints2d: torch.Tensor         # (B, 17, 2) full-image pixels
    pose_rotmats: torch.Tensor     # (B, 24, 3, 3) root first
    shape: torch.Tensor            # (B, 10) augmented betas
    verts_render: torch.Tensor     # (B, V, 3) the vertices rendered (deviated)
    cam_t: torch.Tensor            # (B, 3)
    cam_K: torch.Tensor            # (3, 3)


def _eager_batch(draws: Optional[SyntheticDraws], pose: torch.Tensor, shape: torch.Tensor,
                 assets: SmplAssets, cfg: TrainConfig, augment: bool) -> SyntheticBatch:
    """`generate_synthetic_batch`'s batch op by op, each stage in its span."""
    with span("straps.synth.body"):
        body = _body(draws, pose, shape, assets, cfg, augment)
    with span("straps.synth.render"):
        # Back faces culled: the part map is the same on the watertight
        # mesh, and the kernel skips chunks of back faces.
        parts, _ = render_part_seg(body.verts_render, body.cam_t, body.cam_K, assets.faces,
                                   assets.face_parts, cfg.img_wh, cull_backfaces=True)
        parts = parts.to(torch.float32)
    with span("straps.synth.proxy"):
        return _proxy_batch(body, parts, draws, cfg, augment)


def _part_seg_planes(body: _Body, assets: SmplAssets, cfg: TrainConfig):
    """`render_part_seg`'s planes and bounds of the body, as `_eager_batch`
    renders it."""
    return part_seg_planes(body.verts_render, body.cam_t, body.cam_K, assets.faces, cfg.img_wh,
                           cull_backfaces=True)


def _body(draws: Optional[SyntheticDraws], pose: torch.Tensor, shape: torch.Tensor,
          assets: SmplAssets, cfg: TrainConfig, augment: bool) -> _Body:
    """Augmented SMPL and camera, the SMPL body, its joints projected."""
    B = pose.shape[0]
    dev = pose.device
    img_wh = cfg.img_wh
    mean_cam_t = device_constant(cfg.mean_cam_t, torch.float32, dev).expand(B, 3)
    cam_K = device_constant(get_intrinsics_matrix(img_wh, img_wh, cfg.focal_length).tolist(),
                            torch.float32, dev)
    mean_shape = device_constant(assets.mean_shape, torch.float32, dev)
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
    return _Body(out.vertices, reposed.vertices, joints_h36mlsp, joints2d, pose_rotmats,
                 tgt_shape, verts_render, cam_t, cam_K)


def _proxy_batch(body: _Body, parts: torch.Tensor, draws: Optional[SyntheticDraws],
                 cfg: TrainConfig, augment: bool) -> SyntheticBatch:
    """The crop, the proxy's degradations and the batch, from the body and
    its float32 part map."""
    B = parts.shape[0]
    dev = parts.device
    img_wh = cfg.img_wh
    joints2d = body.joints2d
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
        target_verts=body.vertices,
        target_reposed_verts=body.reposed,
        target_joints_h36mlsp=body.joints_h36mlsp,
        target_joints2d_coco=joints2d,
        target_vis=vis,
        target_pose_rotmats=body.pose_rotmats,
        target_shape=body.shape,
    )
