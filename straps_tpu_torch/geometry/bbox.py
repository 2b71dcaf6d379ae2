"""Square silhouette bounding-box crops + nearest resize: the training crop
(jittered, clamped at the image) and the inference crop (zero-padded)
(counterpart of `straps_tpu/geometry/bbox.py`).

Batched over the leading dimension.  The resize is a plain gather (the JAX
package's one-hot matmul is a TPU workaround with the same output).  Nearest
sampling follows cv2's INTER_NEAREST: src = floor(dst * src_size / dst_size).
"""

from typing import Optional, Tuple

import torch

from straps_tpu_torch.utils.device import device_constant


def _f32(value, like: torch.Tensor) -> torch.Tensor:
    """A float32 tensor of `value` on `like`'s device, so that arithmetic
    with it rounds in float32 as the reference does; a Python number's is
    made once a device (`device_constant`)."""
    if isinstance(value, (int, float)):
        return device_constant(value, torch.float32, like.device)
    return torch.as_tensor(value, dtype=torch.float32, device=like.device)


def mask_bounding_box(mask: torch.Tensor):
    """(B, H, W) masks -> inclusive (r0, r1, c0, c1), each (B,) int32, of the
    nonzero pixels; all zeros for an empty mask."""
    fg = mask != 0
    B, h, w = mask.shape
    rows = fg.any(dim=2)
    cols = fg.any(dim=1)
    ridx = torch.arange(h, dtype=torch.int32, device=mask.device)
    cidx = torch.arange(w, dtype=torch.int32, device=mask.device)
    big = 1 << 30
    r0 = torch.where(rows, ridx, big).amin(dim=1)
    r1 = torch.where(rows, ridx, -big).amax(dim=1)
    c0 = torch.where(cols, cidx, big).amin(dim=1)
    c1 = torch.where(cols, cidx, -big).amax(dim=1)
    empty = ~rows.any(dim=1)
    zero = torch.zeros_like(r0)
    return (torch.where(empty, zero, r0), torch.where(empty, zero, r1),
            torch.where(empty, zero, c0), torch.where(empty, zero, c1))


def square_bbox_corners(seg: torch.Tensor, scale_factor,
                        centre_offset: Optional[torch.Tensor] = None):
    """Unclamped int32 corners (top_r, top_c, bot_r, bot_c), each (B,), of
    the square silhouette-bbox crop.  `scale_factor` is a float or (B,)
    float32; `centre_offset` an optional (B, 2) float32 (row, col) shift of
    the centre.  Float32 arithmetic, truncation toward zero, as the
    reference."""
    r0, r1, c0, c1 = mask_bounding_box(seg)
    two = _f32(2.0, seg)
    centre_r = (r0 + r1).to(torch.float32) / two
    centre_c = (c0 + c1).to(torch.float32) / two
    if centre_offset is not None:
        centre_r = centre_r + centre_offset[:, 0]
        centre_c = centre_c + centre_offset[:, 1]
    bb_h = (r1 - r0).to(torch.float32)
    bb_w = (c1 - c0).to(torch.float32)
    wh = torch.maximum(bb_h, bb_w) * _f32(scale_factor, seg)
    half = wh / two
    top_r = (centre_r - half).to(torch.int32)
    top_c = (centre_c - half).to(torch.int32)
    bot_r = (centre_r + half).to(torch.int32)
    bot_c = (centre_c + half).to(torch.int32)
    return top_r, top_c, bot_r, bot_c


def _nearest_resample(seg: torch.Tensor, r_start: torch.Tensor,
                      c_start: torch.Tensor, crop_h: torch.Tensor,
                      crop_w: torch.Tensor, out_wh: int) -> torch.Tensor:
    """`seg[b, r_start + floor(y*crop_h/out), c_start + floor(x*crop_w/out)]`,
    zero outside the source image: (B, H, W) -> (B, out_wh, out_wh)."""
    B, h, w = seg.shape
    ys = torch.arange(out_wh, dtype=torch.float32, device=seg.device)
    out = torch.full_like(ys, out_wh)
    src_r = r_start[:, None] + torch.floor(
        ys * crop_h.to(torch.float32)[:, None] / out).to(torch.int32)
    src_c = c_start[:, None] + torch.floor(
        ys * crop_w.to(torch.float32)[:, None] / out).to(torch.int32)
    valid = (((src_r >= 0) & (src_r < h))[:, :, None]
             & ((src_c >= 0) & (src_c < w))[:, None, :])
    gr = src_r.clamp(0, h - 1).long()
    gc = src_c.clamp(0, w - 1).long()
    bidx = torch.arange(B, device=seg.device)[:, None, None]
    picked = seg[bidx, gr[:, :, None], gc[:, None, :]]
    return torch.where(valid, picked, torch.zeros_like(picked))


def crop_and_resize_padded(seg: torch.Tensor, joints2d: torch.Tensor,
                           out_wh: int, scale_factor: float = 1.2
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Square bbox crop, zero-padded where it leaves the image, resized to
    out_wh; joints offset by the unclamped top-left corner and scaled.

    Args:
      seg: (B, H, W); joints2d: (B, J, 2) pixel (x, y).
    Returns:
      (B, out_wh, out_wh) crops and (B, J, 2) joints.
    """
    top_r, top_c, bot_r, bot_c = square_bbox_corners(seg, scale_factor)
    crop_h = torch.clamp(bot_r - top_r, min=1)
    crop_w = torch.clamp(bot_c - top_c, min=1)
    out = _nearest_resample(seg, top_r, top_c, crop_h, crop_w, out_wh)
    shifted = joints2d - torch.stack([top_c, top_r], dim=-1).to(torch.float32)[:, None, :]
    scale = torch.stack([_f32(out_wh, seg) / crop_w.to(torch.float32),
                         _f32(out_wh, seg) / crop_h.to(torch.float32)], dim=-1)
    return out, shifted * scale[:, None, :]


def batch_crop_and_resize(segs: torch.Tensor, joints2d: torch.Tensor, out_wh: int,
                          scale_factors: torch.Tensor, centre_offsets: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training crop: the square bbox of side max(h, w) * scale factor
    around the jittered centre, its corners clamped at 0 and the crop
    truncated at the image size (it shrinks there, changing its aspect
    ratio), resized to out_wh; joints offset by the clamped top-left corner
    and scaled.

    Args:
      segs: (B, H, W); joints2d: (B, J, 2) pixel (x, y);
      scale_factors: (B,) float32; centre_offsets: (B, 2) float32 (row, col).
    Returns:
      (B, out_wh, out_wh) crops and (B, J, 2) joints.
    """
    h, w = segs.shape[1:]
    top_r, top_c, bot_r, bot_c = square_bbox_corners(segs, scale_factors,
                                                     centre_offsets)
    top_r, top_c, bot_r, bot_c = (torch.clamp(x, min=0)
                                  for x in (top_r, top_c, bot_r, bot_c))
    crop_h = torch.clamp(torch.clamp(bot_r, max=h) - top_r, min=1)
    crop_w = torch.clamp(torch.clamp(bot_c, max=w) - top_c, min=1)
    out = _nearest_resample(segs, top_r, top_c, crop_h, crop_w, out_wh)
    shifted = joints2d - torch.stack([top_c, top_r], dim=-1).to(torch.float32)[:, None, :]
    scale = torch.stack([_f32(out_wh, segs) / crop_w.to(torch.float32),
                         _f32(out_wh, segs) / crop_h.to(torch.float32)], dim=-1)
    return out, shifted * scale[:, None, :]


def crop_and_resize_seg_joints_centre(seg: torch.Tensor, joints2d: torch.Tensor, out_wh: int,
                                      scale_factor, centre_offset: torch.Tensor
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sample's training crop (`batch_crop_and_resize` of a batch of
    one): seg (H, W), joints2d (J, 2) pixel (x, y), a scalar scale factor
    and a (2,) float32 (row, col) centre shift -> (out_wh, out_wh) crop and
    (J, 2) joints (`utils/image_utils.py:44-105`)."""
    out, joints = batch_crop_and_resize(
        seg[None], joints2d[None], out_wh, _f32(scale_factor, seg).reshape(1),
        torch.as_tensor(centre_offset, dtype=torch.float32, device=seg.device).reshape(1, 2))
    return out[0], joints[0]


def crop_and_resize_seg_joints(seg: torch.Tensor, joints2d: torch.Tensor, out_wh: int,
                               scale_factor) -> Tuple[torch.Tensor, torch.Tensor]:
    """`crop_and_resize_seg_joints_centre` around the silhouette box's own
    centre."""
    return crop_and_resize_seg_joints_centre(seg, joints2d, out_wh, scale_factor,
                                             torch.zeros(2, dtype=torch.float32))


def pad_to_square_params(height: int, width: int) -> Tuple[int, int]:
    """(top, left) border widths that zero-pad an image to a square
    (`utils/image_utils.py:6-21`): the same border on both sides, the
    shorter side padded by half the difference, rounded down."""
    if width < height:
        return 0, (height - width) // 2
    return (width - height) // 2, 0


def pad_to_square(image: torch.Tensor) -> torch.Tensor:
    """Zero-pad an (H, W[, C]) image to a square, the same border on both
    sides (`utils/image_utils.py:6-21`; the result is square only when the
    sides differ by an even number, as there)."""
    h, w = image.shape[:2]
    top, left = pad_to_square_params(h, w)
    out = image.new_zeros((h + 2 * top, w + 2 * left) + tuple(image.shape[2:]))
    out[top:top + h, left:left + w] = image
    return out
