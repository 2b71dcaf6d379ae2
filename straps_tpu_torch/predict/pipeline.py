"""Batched inference rollout: proxies -> SMPL predictions, and the predict
path over cached proxies or images (counterpart of
`straps_tpu/predict/pipeline.py`).

regressor -> rot6d -> SMPL -> reposed SMPL -> projection, in one call under
`torch.inference_mode`.  The proxies come from cached silhouettes and
joints, or from PNG and JPEG images through the detector front end
(`detect_and_build_proxies`): Keypoint-RCNN joints, and PointRend or
DensePose silhouettes.
"""

import glob
import os
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from straps_tpu_torch.config import PredictConfig
from straps_tpu_torch.data.native_io import load_npy_batch
from straps_tpu_torch.geometry.bbox import pad_to_square_params
from straps_tpu_torch.geometry.camera import (
    orthographic_project, weak_perspective_to_camera_translation,
)
from straps_tpu_torch.geometry.joints import undo_keypoint_normalisation
from straps_tpu_torch.geometry.rotations import rot6d_to_rotmat
from straps_tpu_torch.models.convert import (
    bfloat16_variance_layers, flax_to_torch_state_dict, load_reference_checkpoint,
    state_dict_to_tensors,
)
from straps_tpu_torch.models.regressor import (
    SingleInputRegressor, build_regressor, init_random_weights,
)
from straps_tpu_torch.parallel.mesh import gather_batch, replicate, shard_batch
from straps_tpu_torch.perception import rcnn
from straps_tpu_torch.perception.convert_d2 import load_d2_pkl, load_detector_state
from straps_tpu_torch.perception.frontend import (
    run_detector_batched, select_keypoints, select_silhouette,
)
from straps_tpu_torch.predict.proxy import batch_silhouettes_joints_to_proxies
from straps_tpu_torch.render.vis import (
    densepose_overlay_vis, keypoints_vis, proxy_vis_batch, render_body_vis_batch,
    scatter_vis, silhouette_overlay_vis, verts_over_image_vis,
)
from straps_tpu_torch.smpl.assets import SmplAssets, load_assets
from straps_tpu_torch.smpl.model import select_joint_sets, smpl_forward
from straps_tpu_torch.utils.checkpoints import (
    decode_meta_str, load_checkpoint, restore_checkpoint,
)
from straps_tpu_torch.utils.device import resolve_device
from straps_tpu_torch.utils.image import cv2_resize_linear_u8
from straps_tpu_torch.utils.jpeg import decode_jpeg_bytes
from straps_tpu_torch.utils.png import SIGNATURE as PNG_SIGNATURE, decode_png_bytes, write_png
from straps_tpu_torch.utils.profiling import span

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_predict_fn(model: SingleInputRegressor, assets: SmplAssets,
                    img_wh: int, input_dtype: Optional[str] = None, mesh=None
                    ) -> Callable[[torch.Tensor], Dict[str, torch.Tensor]]:
    """proxies (B, H, W, 18) -> dict of predictions, on the model's device.

    `input_dtype`: optional cast of the proxy before the encoder
    ('bfloat16': binary channels stay exact, gaussian heatmap channels
    round).  None keeps float32.

    `mesh`: optional `parallel.DataMesh`: the model is rank 0's
    (`replicate`), each rank predicts its rows of the global batch it is
    given (B divisible by the mesh size) and every rank returns the global
    predictions (`gather_batch`).
    """
    cast = _DTYPES[input_dtype] if input_dtype is not None else None
    model.eval()
    if mesh is not None:
        replicate(model, mesh)

    @torch.inference_mode()
    def predict(proxies: torch.Tensor) -> Dict[str, torch.Tensor]:
        if mesh is not None:
            return gather_batch(predict_rows(shard_batch(proxies, mesh)), mesh)
        return predict_rows(proxies)

    def predict_rows(proxies: torch.Tensor) -> Dict[str, torch.Tensor]:
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
    state's BatchNorm statistics, and the heatmap mode it records; an
    orbax checkpoint directory of the JAX package -> the same from its
    tree (`best_params`, `state.batch_stats`, `meta.heatmap_mode`), or a
    plain `{params, batch_stats}` tree, as the JAX package's loader reads
    it.  Returns (model in eval mode, resolved heatmap mode)."""
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
    elif os.path.isdir(cfg.checkpoint):
        tree = restore_checkpoint(cfg.checkpoint)
        if "best_params" in tree:
            params, batch_stats = tree["best_params"], tree["state"]["batch_stats"]
        else:
            params, batch_stats = tree["params"], tree["batch_stats"]
        model.load_state_dict(state_dict_to_tensors(flax_to_torch_state_dict(
            {"params": params, "batch_stats": batch_stats})), strict=True)
        for name, mode in bfloat16_variance_layers(
                {"params": params, "batch_stats": batch_stats}).items():
            model.get_submodule(name).bfloat16_variance = mode
        meta = tree.get("meta") or {}
        if "heatmap_mode" in meta:
            trained_mode = decode_meta_str(meta["heatmap_mode"])
    else:
        raise NotImplementedError(
            f"{cfg.checkpoint}: the PyTorch port reads reference .tar checkpoints, "
            f"its own training checkpoints (.pt) and the JAX package's orbax "
            f"checkpoint directories")
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


DETECTOR_FRONT_ENDS = ("pointrend", "densepose")


def build_detector_models(cfg: PredictConfig, output_size: int, device="cuda",
                          seed: int = 0, build_vis: bool = False):
    """The keypoint detector and the silhouette detector of
    `cfg.silhouettes_from` (PointRend-RCNN R50-FPN or DensePose-RCNN
    R101-FPN) on `device` in eval mode, with the config's budgets and
    backbone dtype, boxes and masks in an `output_size` frame; DensePose
    also returns its frame part maps when `build_vis` (the overlay's
    input).  Each is built on the `meta` device and given its detectron2
    checkpoint's tensors, or seeded random weights where its checkpoint is
    None."""
    if cfg.silhouettes_from not in DETECTOR_FRONT_ENDS:
        raise ValueError(f"silhouettes_from must be one of {DETECTOR_FRONT_ENDS} for the "
                         f"detector front end, got {cfg.silhouettes_from!r}")
    dev = resolve_device(device)
    kw = dict(output_size=output_size, backbone_dtype=cfg.detector_backbone_dtype,
              score_thresh=float(cfg.detector_score_thresh))
    if cfg.detector_post_nms_topk:
        kw["post_nms_topk"] = int(cfg.detector_post_nms_topk)
    if cfg.detector_max_detections:
        kw["max_detections"] = int(cfg.detector_max_detections)
    if cfg.silhouettes_from == "pointrend":
        silhouette = rcnn.PointRendRCNN, {}
    else:
        silhouette = rcnn.DensePoseRCNN, {"output_part_maps": build_vis}
    models = []
    for i, ((cls, extra), ckpt) in enumerate((((rcnn.KeypointRCNN, {}), cfg.keypoint_checkpoint),
                                              (silhouette, cfg.silhouette_checkpoint))):
        with torch.device("meta"):
            model = cls(**kw, **extra)
        with span("straps.detect.build"):
            if ckpt:
                models.append(load_detector_state(model, load_d2_pkl(ckpt), dev))
            else:
                rcnn.init_random_weights(model, torch.Generator().manual_seed(seed + i))
                models.append(model.to(dev).eval())
    return models[0], models[1]


def read_image(path: str) -> np.ndarray:
    """One image file as `cv2.imread(path)[:, :, ::-1]` reads it: uint8
    (H, W, 3) RGB.  As cv2 does, the decoder is chosen by the file's first
    bytes, not its name: JPEG (FF D8) or PNG (its signature); anything
    else raises a ValueError naming the file."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"\xff\xd8":
        return decode_jpeg_bytes(data, path)
    if data[:8] == PNG_SIGNATURE:
        return decode_png_bytes(data, path)
    raise ValueError(f"{path}: neither a JPEG nor a PNG file (first bytes {data[:8].hex()})")


def _read_padded(path: str) -> np.ndarray:
    """`read_image`, padded to a square with zeros."""
    img = read_image(path)
    top, left = pad_to_square_params(*img.shape[:2])
    return np.pad(img, ((top, top), (left, left), (0, 0)))


def read_images(input_dir: str, size: int, device) -> Tuple[List[str], torch.Tensor]:
    """The folder's `*.png` and `*.jpg` images in the JAX pipeline's order
    (sorted by full path, so a PNG and a JPEG of one stem are two entries):
    each padded to a square and resized to (size, size) as cv2's
    INTER_LINEAR does (`predict_3D.py:97-108`) -> names and (N, size,
    size, 3) uint8 RGB on `device`.

    The images are decoded in a thread a core (the decoders are host C++
    called through ctypes, which releases the GIL); the resizes follow on
    `device` in the folder's order as the decodes come in.  The first
    image that does not decode raises, as a loop over the folder would."""
    paths = sorted(glob.glob(os.path.join(input_dir, "*.png"))
                   + glob.glob(os.path.join(input_dir, "*.jpg")))
    if not paths:
        raise FileNotFoundError(f"no images in {input_dir}")
    with ThreadPoolExecutor(min(len(paths), os.cpu_count() or 1)) as pool:
        images = [cv2_resize_linear_u8(torch.as_tensor(img, device=device), size, size)
                  for img in pool.map(_read_padded, paths)]
    names = [os.path.splitext(os.path.basename(path))[0] for path in paths]
    return names, torch.stack(images)


def detect_and_build_proxies(cfg: PredictConfig, build_vis: bool = True,
                             heatmap_mode: str = "clean", device="cuda",
                             size: int = rcnn.DEFAULT_IMAGE_SIZE,
                             test_size: int = rcnn.DETECTOR_TEST_SIZE):
    """The detector front end over `cfg.input_dir` (`predict_3D.py:97-126`):
    images padded to square and resized to `size`; Keypoint-RCNN joints and
    PointRend or DensePose silhouettes (`cfg.silhouettes_from`) at
    `test_size` (Pillow's bilinear resize on the device), mapped back to
    the `size` frame; the largest centred instance of each; the proxies.
    The silhouettes and joints are written to `<out_dir>/proxies` in
    `load_cached_proxies`' format.

    Returns (names, (N, img_wh, img_wh, 18) proxies, vis): vis is None
    without `build_vis`, else the image crops the proxies' cameras live in
    (numpy, one per image) and the (N, size, size, 3) uint8 joint and
    silhouette overlays: the mask at half opacity for PointRend, the
    selected detection's frame part labels in viridis for DensePose.
    """
    dev = resolve_device(device)
    missing = [name for name in ("keypoint_checkpoint", "silhouette_checkpoint")
               if getattr(cfg, name) is None]
    if missing:
        if not cfg.allow_random_detectors:
            raise ValueError(
                f"detector checkpoint(s) not configured: {missing}. Random-init detectors "
                f"produce garbage proxies; set --allow-random-detectors "
                f"(allow_random_detectors=True) for structure/throughput smoke runs, or "
                f"provide converted detectron2 checkpoints.")
        warnings.warn(f"RANDOM-WEIGHT DETECTORS in use ({missing}): proxy representations "
                      f"and all downstream SMPL predictions are meaningless.", UserWarning,
                      stacklevel=2)
    with span("straps.predict.decode"):
        names, images = read_images(cfg.input_dir, size, dev)
    kp_model, silh_model = build_detector_models(cfg, size, dev, build_vis=build_vis)
    with span("straps.detect.keypoint"):
        kp_out = run_detector_batched(kp_model, images, test_size)
    with span("straps.detect.silhouette"):
        silh_out = run_detector_batched(silh_model, images, test_size)
    with span("straps.detect.select"):
        kps, sils, selected = [], [], []
        for i in range(len(names)):
            kps.append(select_keypoints(kp_out, i, size, size))
            sil, sel = select_silhouette(silh_out, i)
            sils.append(sil)
            selected.append(sel)
        joints = [kp[:, :2] for kp in kps]
        save_proxies(os.path.join(cfg.out_dir, "proxies"), names, sils, joints)
    proxies, _ = batch_silhouettes_joints_to_proxies(
        torch.as_tensor(np.stack(sils), device=dev), torch.as_tensor(np.stack(joints), device=dev),
        cfg.img_wh, heatmap_mode=heatmap_mode)
    if not build_vis:
        return names, proxies, None
    host = images.cpu().numpy()
    sil_vis = silhouette_overlay_vis(images, torch.as_tensor(np.stack(sils), device=dev))
    if cfg.silhouettes_from == "densepose":
        sil_vis = _densepose_overlays(silh_out, selected, images, sil_vis)
    vis = {"crops": [crop_image_like_proxy(sil, img) for sil, img in zip(sils, host)],
           "joints_vis": keypoints_vis(images, torch.as_tensor(np.stack(kps), device=dev)),
           "silhouette_vis": sil_vis}
    return names, proxies, vis


def _densepose_overlays(out: dict, selected: Sequence, images: torch.Tensor,
                        plain: torch.Tensor) -> torch.Tensor:
    """The DensePose overlay of each image's selected detection, from its
    frame part map; `plain` (the image itself under an empty mask) where
    nothing was selected, as the JAX pipeline does."""
    N, H, W, _ = images.shape
    labels = [torch.zeros(H, W, dtype=torch.uint8) if sel is None
              else torch.as_tensor(out["part_map"][i][sel]) for i, sel in enumerate(selected)]
    overlays = densepose_overlay_vis(images, torch.stack(labels).to(images.device))
    found = torch.as_tensor([sel is not None for sel in selected], device=images.device)
    return torch.where(found[:, None, None, None], overlays, plain)


def crop_image_like_proxy(sil: np.ndarray, img: np.ndarray,
                          scale_factor: float = 1.2) -> np.ndarray:
    """Crop `img` with the square silhouette-bbox crop the proxy uses
    (float32 corner arithmetic truncated toward zero, as
    `geometry/bbox.py::square_bbox_corners`), zero-padded where it leaves
    the image, not resized: the crop the predicted camera lives in."""
    sil = np.asarray(sil)
    rows = np.flatnonzero(sil.any(axis=1))
    cols = np.flatnonzero(sil.any(axis=0))
    if len(rows) == 0 or len(cols) == 0:
        r0 = r1 = c0 = c1 = 0
    else:
        r0, r1 = int(rows[0]), int(rows[-1])
        c0, c1 = int(cols[0]), int(cols[-1])
    f32 = np.float32
    centre_r = f32(r0 + r1) / f32(2.0)
    centre_c = f32(c0 + c1) / f32(2.0)
    half = f32(max(r1 - r0, c1 - c0)) * f32(scale_factor) / f32(2.0)
    top_r, top_c = int(centre_r - half), int(centre_c - half)
    bot_r, bot_c = int(centre_r + half), int(centre_c + half)
    out = np.zeros((max(bot_r - top_r, 1), max(bot_c - top_c, 1), img.shape[2]), img.dtype)
    sr0, sc0 = max(top_r, 0), max(top_c, 0)
    sr1, sc1 = min(bot_r, img.shape[0]), min(bot_c, img.shape[1])
    if sr1 > sr0 and sc1 > sc0:
        out[sr0 - top_r:sr1 - top_r, sc0 - top_c:sc1 - top_c] = img[sr0:sr1, sc0:sc1]
    return out


VERTS_VIS_WH = 512


@torch.inference_mode()
def write_verts_vis(out_dir: str, names: Sequence[str], verts: torch.Tensor,
                    cam_wp: torch.Tensor, crops: Optional[Sequence[np.ndarray]]) -> None:
    """`verts_vis/verts_<name>.png` per image (`predict_3D.py:144-167`):
    with image crops, the vertices projected with the weak-perspective
    camera and un-normalised to 512 px, over the crop resized to 512 x 512
    (cv2's INTER_LINEAR); without, the vertices' 3D scatter."""
    for i, name in enumerate(names):
        path = os.path.join(out_dir, "verts_vis", f"verts_{name}.png")
        if crops is None:
            scatter_vis(verts[i], path)
            continue
        verts2d = undo_keypoint_normalisation(
            orthographic_project(verts[i:i + 1], cam_wp[i:i + 1]), VERTS_VIS_WH)[0]
        crop = cv2_resize_linear_u8(torch.as_tensor(crops[i], device=verts.device),
                                    VERTS_VIS_WH, VERTS_VIS_WH)
        verts_over_image_vis(verts2d, crop, path)


# The reference's reposed view: the T-pose at weak-perspective camera
# [0.8, 0, -0.2], rotated 180 degrees about x (`predict_3D.py:172-176`).
REPOSED_CAM_WP = (0.8, 0.0, -0.2)


def predict_3d(cfg: PredictConfig, save_vis: bool = True,
               device="cuda") -> Dict[str, np.ndarray]:
    """Predict over cached proxies (`silhouettes_from='cached'`) or over
    the PNG images of `cfg.input_dir` through the detector front end
    (`'pointrend'` or `'densepose'`: `detect_and_build_proxies` at
    `cfg.detector_image_size` and `cfg.detector_test_size`), and write the
    outputs to `cfg.out_dir`.

    Per image `<name>`: `<name>_verts.npy`, `_shape.npy`,
    `_pose_rotmats.npy` and `_cam_wp.npy`; with `save_vis`, the renders
    `rend_vis/rend_<name>.png` (composited over the image crop the camera
    lives in, for images) and `rend_vis/reposed_<name>.png` at `cfg.img_wh`
    (lit as in the reference's pyrender scene), and `proxy_vis/<name>.png`
    for cached proxies or `proxy_vis/silhouette_<name>.png` and
    `proxy_vis/joints2D_<name>.png` (with the joint indices) for images,
    and `verts_vis/verts_<name>.png`: the predicted vertices projected with
    the camera over the 512 x 512 resize of the image crop, or the 3D
    scatter of the vertices for cached proxies (matplotlib's figures,
    `render/figures.py`).  All bodies of a vis kind are rendered in one
    face-id rasterisation.  Returns the predictions as numpy arrays, plus
    `names`.
    """
    if cfg.silhouettes_from not in ("cached",) + DETECTOR_FRONT_ENDS:
        raise ValueError(f"silhouettes_from must be 'cached', 'pointrend' or 'densepose', "
                         f"got {cfg.silhouettes_from!r}")
    with span("straps.predict"):
        with span("straps.predict.load"):
            dev = resolve_device(device)
            assets = load_assets(cfg.smpl_dir, device=dev)
            model, heatmap_mode = load_regressor_variables(cfg, assets, device=dev)
        with span("straps.predict.proxies"):
            if cfg.silhouettes_from == "cached":
                names, proxies = load_cached_proxies(cfg.proxy_dir or cfg.input_dir, cfg.img_wh,
                                                     heatmap_mode=heatmap_mode, device=dev)
                vis = None
            else:
                names, proxies, vis = detect_and_build_proxies(
                    cfg, build_vis=save_vis, heatmap_mode=heatmap_mode, device=dev,
                    size=cfg.detector_image_size, test_size=cfg.detector_test_size)
        with span("straps.predict.regress"):
            out = make_predict_fn(model, assets, cfg.img_wh,
                                  input_dtype=cfg.proxy_input_dtype)(proxies)
            out_np = {k: v.cpu().numpy() for k, v in out.items()}

        with span("straps.predict.write_npy"):
            os.makedirs(cfg.out_dir, exist_ok=True)
            for i, name in enumerate(names):
                for key in ("verts", "shape", "pose_rotmats", "cam_wp"):
                    np.save(os.path.join(cfg.out_dir, f"{name}_{key}.npy"), out_np[key][i])

        if save_vis:
            with span("straps.predict.render"), torch.inference_mode():
                rend = render_body_vis_batch(out["verts"], out["cam_wp"], assets,
                                             img_wh=cfg.img_wh,
                                             image=None if vis is None else vis["crops"])
                reposed_cam = torch.tensor(REPOSED_CAM_WP, device=dev).expand(len(names), 3)
                reposed = render_body_vis_batch(out["reposed_verts"], reposed_cam, assets,
                                                img_wh=cfg.img_wh, rotate_x180=True)
                if vis is None:
                    proxy_imgs = {"": proxy_vis_batch(proxies)}
                else:
                    proxy_imgs = {"silhouette_": vis["silhouette_vis"],
                                  "joints2D_": vis["joints_vis"]}
                rend, reposed = rend.cpu().numpy(), reposed.cpu().numpy()
                proxy_imgs = {k: v.cpu().numpy() for k, v in proxy_imgs.items()}
            with span("straps.predict.figures"):
                write_verts_vis(cfg.out_dir, names, out["verts"], out["cam_wp"],
                                None if vis is None else vis["crops"])
            with span("straps.predict.write_png"):
                for i, name in enumerate(names):
                    write_png(os.path.join(cfg.out_dir, "rend_vis", f"rend_{name}.png"),
                              rend[i])
                    write_png(os.path.join(cfg.out_dir, "rend_vis", f"reposed_{name}.png"),
                              reposed[i])
                    for prefix, imgs in proxy_imgs.items():
                        write_png(os.path.join(cfg.out_dir, "proxy_vis", f"{prefix}{name}.png"),
                                  imgs[i])
    out_np["names"] = names
    return out_np
