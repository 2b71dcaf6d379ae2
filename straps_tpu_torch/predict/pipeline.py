"""Batched inference rollout: proxies -> SMPL predictions, and the predict
path over cached proxies (counterpart of `make_predict_fn`,
`resolve_heatmap_mode`, `load_regressor_variables`, `load_cached_proxies`,
`save_proxies` and `predict_3d` in `straps_tpu/predict/pipeline.py`).

regressor -> rot6d -> SMPL -> reposed SMPL -> projection, in one call under
`torch.inference_mode`.  The detector front end that builds proxies from
images is not ported yet: `predict_3d` reads cached silhouettes and joints.
"""

import glob
import os
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from straps_tpu_torch.config import PredictConfig
from straps_tpu_torch.data.native_io import load_npy_batch
from straps_tpu_torch.geometry.camera import (
    orthographic_project, weak_perspective_to_camera_translation,
)
from straps_tpu_torch.geometry.joints import undo_keypoint_normalisation
from straps_tpu_torch.geometry.rotations import rot6d_to_rotmat
from straps_tpu_torch.models.convert import load_reference_checkpoint
from straps_tpu_torch.models.regressor import (
    SingleInputRegressor, build_regressor, init_random_weights,
)
from straps_tpu_torch.predict.proxy import batch_silhouettes_joints_to_proxies
from straps_tpu_torch.render.vis import proxy_vis_batch, render_body_vis_batch
from straps_tpu_torch.smpl.assets import SmplAssets, load_assets
from straps_tpu_torch.smpl.model import select_joint_sets, smpl_forward
from straps_tpu_torch.utils.checkpoints import load_checkpoint
from straps_tpu_torch.utils.device import resolve_device
from straps_tpu_torch.utils.png import write_png

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_predict_fn(model: SingleInputRegressor, assets: SmplAssets,
                    img_wh: int, input_dtype: Optional[str] = None
                    ) -> Callable[[torch.Tensor], Dict[str, torch.Tensor]]:
    """proxies (B, H, W, 18) -> dict of predictions, on the model's device.

    `input_dtype`: optional cast of the proxy before the encoder
    ('bfloat16': binary channels stay exact, gaussian heatmap channels
    round).  None keeps float32.
    """
    cast = _DTYPES[input_dtype] if input_dtype is not None else None
    model.eval()

    @torch.inference_mode()
    def predict(proxies: torch.Tensor) -> Dict[str, torch.Tensor]:
        if cast is not None:
            proxies = proxies.to(cast)
        cam, pose6d, shape = model(proxies)
        B = cam.shape[0]
        rotmats = rot6d_to_rotmat(pose6d.reshape(B, 24, 6))
        out = smpl_forward(assets, shape, rotmats[:, 1:], rotmats[:, 0:1])
        reposed = smpl_forward(assets, shape)
        _, coco = select_joint_sets(out.joints)
        joints2d = undo_keypoint_normalisation(orthographic_project(coco, cam), img_wh)
        return {
            "cam_wp": cam,
            "cam_t": weak_perspective_to_camera_translation(cam, 5000.0, img_wh),
            "pose_rotmats": rotmats, "shape": shape, "verts": out.vertices,
            "reposed_verts": reposed.vertices, "joints2d": joints2d,
            "joints3d_all": out.joints,
        }

    return predict


def resolve_heatmap_mode(requested: str, trained_mode, source: str) -> str:
    """'auto' takes the checkpoint's heatmap mode (falling back to 'clean');
    an explicit 'clean'/'legacy' wins but warns when it contradicts the
    checkpoint: border-joint channels differ by up to 1.0 between modes."""
    if requested == "auto":
        return trained_mode or "clean"
    if requested not in ("clean", "legacy"):
        raise ValueError(f"heatmap_mode must be 'auto', 'clean' or 'legacy', "
                         f"got {requested!r}")
    if trained_mode is not None and requested != trained_mode:
        warnings.warn(
            f"heatmap_mode={requested!r} contradicts the checkpoint "
            f"({source}): the model was trained on {trained_mode!r} proxies. "
            f"Border-joint heatmap channels differ by up to 1.0 between "
            f"modes, so predictions will be degraded.", UserWarning,
            stacklevel=2)
    return requested


def load_regressor_variables(cfg: PredictConfig, assets: SmplAssets,
                             device="cuda", seed: int = 0
                             ) -> Tuple[SingleInputRegressor, str]:
    """Build the regressor on `device` (`cuda` raises without a card) and
    load its weights per `cfg.checkpoint`: None -> seeded random weights
    (heatmap mode 'clean'); a reference `.tar` -> its
    `best_model_state_dict` (trained on legacy-grid heatmaps); a training
    checkpoint of this package (`.pt`) -> its best parameters with the
    state's BatchNorm statistics, and the heatmap mode it records.
    Returns (model in eval mode, resolved heatmap mode).  The JAX
    package's orbax checkpoints are not read yet."""
    device = resolve_device(device)
    model = build_regressor(assets.mean_pose_6d, assets.mean_shape,
                            in_channels=cfg.model.resnet_in_channels,
                            resnet_layers=cfg.model.resnet_layers,
                            ief_iters=cfg.model.ief_iters,
                            compute_dtype=cfg.model.compute_dtype)
    trained_mode = None
    if cfg.checkpoint is None:
        init_random_weights(model, torch.Generator().manual_seed(seed))
    elif cfg.checkpoint.endswith(".tar"):
        model.load_state_dict(load_reference_checkpoint(cfg.checkpoint), strict=True)
        trained_mode = "legacy"
    elif cfg.checkpoint.endswith(".pt"):
        ckpt = load_checkpoint(cfg.checkpoint)
        model.load_state_dict({**ckpt["state"]["model"], **ckpt["best_params"]}, strict=True)
        trained_mode = ckpt.get("meta", {}).get("heatmap_mode")
    else:
        raise NotImplementedError(
            f"{cfg.checkpoint}: the PyTorch port reads reference .tar checkpoints "
            f"and its own training checkpoints (.pt); orbax checkpoints are not "
            f"ported yet")
    mode = resolve_heatmap_mode(cfg.heatmap_mode, trained_mode, str(cfg.checkpoint))
    return model.to(device).eval(), mode


def load_cached_proxies(proxy_dir: str, img_wh: int, heatmap_mode: str = "clean",
                        device="cuda") -> Tuple[List[str], torch.Tensor]:
    """Cached `<name>_silhouette.npy` (H, W) and `<name>_joints2D.npy`
    (17, 2 or 3) per image -> (sorted names, (N, img_wh, img_wh, 18)
    proxies built on `device`)."""
    dev = resolve_device(device)
    sil_files = sorted(glob.glob(os.path.join(proxy_dir, "*_silhouette.npy")))
    if not sil_files:
        raise FileNotFoundError(f"no *_silhouette.npy files in {proxy_dir}")
    names = [os.path.basename(f)[:-len("_silhouette.npy")] for f in sil_files]
    joint_files = [os.path.join(proxy_dir, f"{n}_joints2D.npy") for n in names]
    sils = load_npy_batch(sil_files, np.load(sil_files[0], mmap_mode="r").shape)
    joints = load_npy_batch(joint_files, np.load(joint_files[0], mmap_mode="r").shape)
    proxies, _ = batch_silhouettes_joints_to_proxies(
        torch.as_tensor(sils, device=dev), torch.as_tensor(joints[:, :, :2], device=dev),
        img_wh, heatmap_mode=heatmap_mode)
    return names, proxies


def save_proxies(proxy_dir: str, names: Sequence[str], sils, joints) -> None:
    """Write silhouettes (H, W) and joints (17, 2) per name in
    `load_cached_proxies`' format, as float32, verbatim: a cached re-run
    builds bit-identical proxies."""
    os.makedirs(proxy_dir, exist_ok=True)
    for name, sil, j in zip(names, sils, joints):
        np.save(os.path.join(proxy_dir, f"{name}_silhouette.npy"), np.asarray(sil, np.float32))
        np.save(os.path.join(proxy_dir, f"{name}_joints2D.npy"), np.asarray(j, np.float32))


# The reference's reposed view: the T-pose at weak-perspective camera
# [0.8, 0, -0.2], rotated 180 degrees about x (`predict_3D.py:172-176`).
REPOSED_CAM_WP = (0.8, 0.0, -0.2)


def predict_3d(cfg: PredictConfig, save_vis: bool = True,
               device="cuda") -> Dict[str, np.ndarray]:
    """Predict over cached proxies and write the outputs to `cfg.out_dir`.

    Per image `<name>`: `<name>_verts.npy`, `_shape.npy`,
    `_pose_rotmats.npy` and `_cam_wp.npy`; with `save_vis`, the renders
    `rend_vis/rend_<name>.png` and `rend_vis/reposed_<name>.png` at
    `cfg.img_wh` (lit as in the reference's pyrender scene) and
    `proxy_vis/<name>.png`.  All bodies of a vis kind are rendered in one
    face-id rasterisation.  Returns the predictions as numpy arrays, plus
    `names`.  The 2D vertex scatter `verts_vis/` is not written (it needs
    matplotlib).
    """
    if cfg.silhouettes_from != "cached":
        raise NotImplementedError(
            f"silhouettes_from={cfg.silhouettes_from!r}: the detector front end "
            f"(pointrend/densepose) is not ported to PyTorch yet (ROADMAP.md, "
            f"queue 1, item 11); use cached silhouettes and joints")
    dev = resolve_device(device)
    assets = load_assets(cfg.smpl_dir, device=dev)
    model, heatmap_mode = load_regressor_variables(cfg, assets, device=dev)
    names, proxies = load_cached_proxies(cfg.proxy_dir or cfg.input_dir, cfg.img_wh,
                                         heatmap_mode=heatmap_mode, device=dev)
    out = make_predict_fn(model, assets, cfg.img_wh,
                          input_dtype=cfg.proxy_input_dtype)(proxies)
    out_np = {k: v.cpu().numpy() for k, v in out.items()}

    os.makedirs(cfg.out_dir, exist_ok=True)
    for i, name in enumerate(names):
        for key in ("verts", "shape", "pose_rotmats", "cam_wp"):
            np.save(os.path.join(cfg.out_dir, f"{name}_{key}.npy"), out_np[key][i])

    if save_vis:
        with torch.inference_mode():
            rend = render_body_vis_batch(out["verts"], out["cam_wp"], assets,
                                         img_wh=cfg.img_wh)
            reposed_cam = torch.tensor(REPOSED_CAM_WP, device=dev).expand(len(names), 3)
            reposed = render_body_vis_batch(out["reposed_verts"], reposed_cam, assets,
                                            img_wh=cfg.img_wh, rotate_x180=True)
            proxy_img = proxy_vis_batch(proxies)
        rend, reposed, proxy_img = (t.cpu().numpy() for t in (rend, reposed, proxy_img))
        for i, name in enumerate(names):
            write_png(os.path.join(cfg.out_dir, "rend_vis", f"rend_{name}.png"), rend[i])
            write_png(os.path.join(cfg.out_dir, "rend_vis", f"reposed_{name}.png"), reposed[i])
            write_png(os.path.join(cfg.out_dir, "proxy_vis", f"{name}.png"), proxy_img[i])
    out_np["names"] = names
    return out_np
