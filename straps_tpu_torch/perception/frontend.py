"""Predict-time detector wrappers (counterpart of
`straps_tpu/perception/frontend.py`): the largest roughly centred instance
(`predict/predict_joints2D.py:5-30`, `predict_silhouette_pointrend.py:7-36`)
and its keypoints or silhouette, selected in numpy on the host; Pillow's
bilinear resize to the detectors' test size, on the device; the detectors
run over a folder in chunks of images, or on one image
(`predict_joints2d`, `predict_silhouette`).
"""

from typing import Dict, Tuple

import numpy as np
import torch

from straps_tpu_torch.perception.rcnn import normalise_image_device
from straps_tpu_torch.utils.device import resolve_device
from straps_tpu_torch.utils.profiling import span


def get_largest_centred_box_index(boxes: np.ndarray, valid: np.ndarray,
                                  orig_w: int, orig_h: int) -> int:
    """The largest valid box whose centre is within orig_w/6 of the image
    centre, else the largest."""
    boxes = np.asarray(boxes)
    valid = np.asarray(valid).astype(bool)
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    areas = np.where(valid, areas, -1.0)
    # A stable sort: of equal areas the earlier detection first.  numpy's
    # default sort breaks ties differently by machine (SIMD sorts on CPUs
    # that have them), and boxes clipped at the frame's edges tie.
    order = np.argsort(-areas, kind="stable")
    for idx in order:
        if not valid[idx]:
            continue
        cx = (boxes[idx, 0] + boxes[idx, 2]) / 2.0
        cy = (boxes[idx, 1] + boxes[idx, 3]) / 2.0
        if abs(cx - orig_w / 2.0) < orig_w / 6.0 and abs(cy - orig_h / 2.0) < orig_w / 6.0:
            return int(idx)
    return int(order[0])


def get_largest_centred_mask_index(masks: np.ndarray, valid: np.ndarray,
                                   orig_w: int, orig_h: int) -> int:
    """The largest valid mask whose bounding-box centre is roughly centred
    (rows within orig_w/4, columns within orig_w/6), else the largest."""
    masks = np.asarray(masks)
    valid = np.asarray(valid).astype(bool)
    areas = np.where(valid, masks.sum(axis=(1, 2)), -1.0)
    # Stable, as for boxes: masks filling boxes clipped alike tie in area.
    order = np.argsort(-areas, kind="stable")
    for idx in order:
        if not valid[idx] or areas[idx] <= 0:
            continue
        rows, cols = np.nonzero(masks[idx])
        cr = (rows.min() + rows.max()) / 2.0
        cc = (cols.min() + cols.max()) / 2.0
        if abs(cr - orig_h / 2.0) < orig_w / 4.0 and abs(cc - orig_w / 2.0) < orig_w / 6.0:
            return int(idx)
    return int(order[0])


def select_keypoints(out: dict, i: int, fw: int, fh: int) -> np.ndarray:
    """Image i's (17, 3) keypoints [x, y, score] of the selected person;
    zeros when nobody was found."""
    valid = np.asarray(out["valid"][i]).astype(bool)
    if not valid.any():
        return np.zeros((17, 3), np.float32)
    idx = get_largest_centred_box_index(out["boxes"][i], valid, fw, fh)
    kp = np.asarray(out["keypoints"][i][idx])
    ks = np.asarray(out["keypoint_scores"][i][idx])
    return np.concatenate([kp, ks[:, None]], axis=1)


def select_silhouette(out: dict, i: int) -> Tuple[np.ndarray, object]:
    """Image i's (H, W) float32 silhouette of the selected instance and its
    index (zeros and None when nothing was found)."""
    valid = np.asarray(out["valid"][i]).astype(bool)
    masks = np.asarray(out["masks"][i])
    mh, mw = masks.shape[-2:]
    if not valid.any():
        return np.zeros((mh, mw), np.float32), None
    idx = get_largest_centred_mask_index(masks, valid, mw, mh)
    return masks[idx].astype(np.float32), idx


# Pillow's 8-bit fixed-point coefficient precision (Resample.c:
# PRECISION_BITS = 32 - 8 - 2).
_PIL_PRECISION_BITS = 22


def _pil_axis_coeffs(in_size: int, out_size: int, quantise: bool = True):
    """Pillow's `precompute_coeffs` for the bilinear (triangle, support 1)
    filter, and `normalize_coeffs_8bpc` when `quantise`: per output pixel
    the tap indices (out, k) and weights, in double, rounded to 2^-22 for
    the uint8 path."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale
    ss = 1.0 / filterscale
    centers = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    xmin = np.maximum((centers - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((centers + support + 0.5).astype(np.int64), in_size)
    ksize = int(np.ceil(support)) * 2 + 1
    taps = xmin[:, None] + np.arange(ksize)[None, :]
    w = 1.0 - np.abs((taps - centers[:, None] + 0.5) * ss)
    w = np.where((w > 0) & (taps < xmax[:, None]), w, 0.0)
    w = w / w.sum(axis=1, keepdims=True)
    if quantise:
        w = np.where(w < 0, w * (1 << _PIL_PRECISION_BITS) - 0.5,
                     w * (1 << _PIL_PRECISION_BITS) + 0.5).astype(np.int64)
    return np.minimum(taps, in_size - 1), w


def _axis_pass(img: torch.Tensor, coeffs, dim: int) -> torch.Tensor:
    """Sum of the taps of `coeffs` along `dim` (int64 or float64)."""
    taps, w = (torch.as_tensor(c, device=img.device) for c in coeffs)
    m = img.movedim(dim, 0)
    tail = (1,) * (m.dim() - 1)
    if img.dtype == torch.int64:
        acc = torch.full((taps.shape[0],) + m.shape[1:], 1 << (_PIL_PRECISION_BITS - 1),
                         dtype=torch.int64, device=img.device)
    else:
        acc = torch.zeros((taps.shape[0],) + m.shape[1:], dtype=img.dtype, device=img.device)
    for k in range(taps.shape[1]):
        acc += m[taps[:, k]] * w[:, k].reshape((-1,) + tail)
    return acc.movedim(0, dim)


def pil_bilinear_resize_u8(images: torch.Tensor, out_w: int, out_h: int) -> torch.Tensor:
    """Pillow's `Image.resize((w, h), BILINEAR)` of uint8 (..., H, W, C)
    images, bit for bit, on their device: detectron2's ResizeShortestEdge.
    Fixed point as Pillow's 8-bit path: coefficients in 2^-22 steps,
    horizontal pass then vertical, each accumulated in int64, rounded half
    up, shifted and clipped to uint8."""
    if images.dtype != torch.uint8:
        raise TypeError(f"pil_bilinear_resize_u8 takes uint8 images, got {images.dtype}; "
                        f"float images go through bilinear_resize_f32")
    img = images
    for dim, out_size in ((-2, out_w), (-3, out_h)):
        if img.shape[dim] != out_size:
            acc = _axis_pass(img.to(torch.int64), _pil_axis_coeffs(img.shape[dim], out_size),
                             img.dim() + dim)
            img = (acc >> _PIL_PRECISION_BITS).clamp(0, 255).to(torch.uint8)
    return img


def bilinear_resize_f32(images: torch.Tensor, out_w: int, out_h: int) -> torch.Tensor:
    """Pillow's bilinear resize of float (..., H, W, C) images (its mode
    'F' semantics): the same coefficients in double, unrounded, unclipped."""
    img = images.to(torch.float64)
    for dim, out_size in ((-2, out_w), (-3, out_h)):
        if img.shape[dim] != out_size:
            img = _axis_pass(img, _pil_axis_coeffs(img.shape[dim], out_size, quantise=False),
                             img.dim() + dim)
    return img.to(images.dtype if images.is_floating_point() else torch.float32)


def _resize_for_test(images: torch.Tensor, test_size) -> torch.Tensor:
    """detectron2's predictor preprocessing of square images: a square
    resize to `test_size` with Pillow's semantics (uint8 bit-exact, float
    unrounded); unchanged when `test_size` is falsy or already matched."""
    if not test_size or tuple(images.shape[-3:-1]) == (test_size, test_size):
        return images
    if images.dtype == torch.uint8:
        return pil_bilinear_resize_u8(images, test_size, test_size)
    return bilinear_resize_f32(images, test_size, test_size)


@torch.inference_mode()
def run_detector_batched(model, images_rgb: torch.Tensor, test_size=None,
                         chunk: int = 8) -> Dict[str, np.ndarray]:
    """Run a detector over (N, H, W, 3) uint8 RGB images on the model's
    device, `chunk` images per forward (the last chunk holds the rest).
    Each chunk is resized to `test_size` and normalised on the device and
    its outputs pulled to the host in one transfer.  Returns the model's
    outputs as numpy arrays with a leading image axis."""
    dev = next(model.parameters()).device
    outs = []
    for s in range(0, images_rgb.shape[0], chunk):
        batch = _resize_for_test(images_rgb[s:s + chunk].to(dev), test_size)
        out = model(normalise_image_device(batch))
        with span("straps.detect.pull"):
            outs.append({k: v.cpu().numpy() for k, v in out.items()})
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}


def _run_one(image_rgb: np.ndarray, model, test_size, device) -> Dict[str, np.ndarray]:
    """The detector on one (H, W, 3) uint8 RGB image, on `device` (the
    model is moved there)."""
    model.to(resolve_device(device))
    return run_detector_batched(model, torch.as_tensor(np.asarray(image_rgb, np.uint8))[None],
                                test_size)


def predict_joints2d(image_rgb: np.ndarray, model, test_size=None,
                     device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """One (H, W, 3) uint8 RGB image through a Keypoint-RCNN -> the (17, 3)
    keypoints [x, y, score] of the largest roughly centred person (zeros
    when nobody is found) and every detection's (D, 4) box (the reference's
    `predict_joints2D` contract).  Boxes and keypoints are in the model's
    `output_size` frame, else the network input's: the `test_size` square
    when set, the image otherwise; the centred selection uses that frame."""
    fw = fh = getattr(model, "output_size", 0) or test_size or 0
    if not fw:
        fh, fw = image_rgb.shape[:2]
    out = _run_one(image_rgb, model, test_size, device)
    return select_keypoints(out, 0, fw, fh), out["boxes"][0]


def predict_silhouette(image_rgb: np.ndarray, model, test_size=None,
                       device="cuda") -> np.ndarray:
    """One (H, W, 3) uint8 RGB image through a PointRend-RCNN or a
    DensePose-RCNN -> the (H', W') float32 binary silhouette of the largest
    roughly centred instance, in the frame the model pastes its masks in;
    zeros of that frame when nothing is found."""
    return select_silhouette(_run_one(image_rgb, model, test_size, device), 0)[0]
