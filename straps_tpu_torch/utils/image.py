"""OpenCV's `cv2.resize` in torch, on any device, so that the port needs no
cv2: INTER_LINEAR bit for bit for uint8 images (what the predict path does
to every input image) and with OpenCV's float arithmetic for float images
(the vis composite); INTER_NEAREST for label maps and silhouettes of any
dtype (the DensePose overlay's ROI paste, the image-frame IoU's inverse
crop).

OpenCV computes each axis's source index and fraction in float from a
double scale, clamps at the borders, and for uint8 rounds the weights to
11-bit fixed point (`INTER_RESIZE_COEF_BITS`).  The horizontal pass sums
in int32; the vertical pass is the SIMD kernel's (each row >> 4, a high
16-bit product with the weight, the two summed, then a rounding >> 2),
with the scalar rounding on a tail that is not a multiple of 16 bytes.  An
exact 2x downscale goes to INTER_AREA, the 2x2 mean.  Bit-exact where a
destination row's bytes are a multiple of 16 (every 512-wide image; held
against cv2 by the tests); rows with a tail can differ by 1 on ~1% of the
pixels.  Float images agree with cv2 to an ulp (cv2's SIMD rounds some
sums differently).
"""

import numpy as np
import torch

_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS
_SIMD_BYTES = 16


def _axis_taps(src: int, dst: int, clamp_fraction: bool):
    """Per destination index: the two source indices (clamped into the
    image) and the float32 fraction of the second, as `cv::resize` computes
    them (`fx = (float)((d + 0.5) * scale - 0.5)`, scale = 1 / (dst /
    src) in double).  With `clamp_fraction` (the x axis) a source index
    before the first texel or at or past the last one gets fraction 0."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    frac = (f - s.astype(np.float32)).astype(np.float32)
    if clamp_fraction:
        low, high = s < 0, s >= src - 1
        frac = np.where(low | high, np.float32(0.0), frac)
        s = np.where(low, 0, np.where(high, src - 1, s))
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), frac


def _is_half(src_h: int, src_w: int, dst_h: int, dst_w: int) -> bool:
    return src_w == 2 * dst_w and src_h == 2 * dst_h


def cv2_resize_linear_u8(image: torch.Tensor, out_w: int, out_h: int) -> torch.Tensor:
    """`cv2.resize(image, (out_w, out_h), interpolation=cv2.INTER_LINEAR)`
    of a uint8 (H, W, C) image, bit for bit, on its device."""
    if image.dtype != torch.uint8:
        raise TypeError(f"cv2_resize_linear_u8 takes uint8, got {image.dtype}")
    h, w, c = image.shape
    dev = image.device
    img = image.to(torch.int64)
    if _is_half(h, w, out_h, out_w):
        s = img[0::2, 0::2] + img[0::2, 1::2] + img[1::2, 0::2] + img[1::2, 1::2]
        return ((s + 2) >> 2).to(torch.uint8)
    x0, x1, fx = _axis_taps(w, out_w, True)
    a0 = torch.as_tensor(np.rint((np.float32(1.0) - fx) * _COEF_SCALE).astype(np.int64), device=dev)
    a1 = torch.as_tensor(np.rint(fx * _COEF_SCALE).astype(np.int64), device=dev)
    hbuf = (img[:, torch.as_tensor(x0, device=dev)] * a0[None, :, None]
            + img[:, torch.as_tensor(x1, device=dev)] * a1[None, :, None])   # (h, out_w, c)
    y0, y1, fy = _axis_taps(h, out_h, False)
    b0 = torch.as_tensor(np.rint((np.float32(1.0) - fy) * _COEF_SCALE).astype(np.int64),
                         device=dev)[:, None]
    b1 = torch.as_tensor(np.rint(fy * _COEF_SCALE).astype(np.int64), device=dev)[:, None]
    s0 = hbuf[torch.as_tensor(y0, device=dev)].reshape(out_h, -1)
    s1 = hbuf[torch.as_tensor(y1, device=dev)].reshape(out_h, -1)
    vec = ((((s0 >> 4) * b0) >> 16) + (((s1 >> 4) * b1) >> 16) + 2) >> 2
    scalar = (s0 * b0 + s1 * b1 + (1 << (2 * _COEF_BITS - 1))) >> (2 * _COEF_BITS)
    n = s0.shape[1]
    out = torch.where(torch.arange(n, device=dev) < n - n % _SIMD_BYTES, vec, scalar)
    return out.clamp(0, 255).to(torch.uint8).reshape(out_h, out_w, c)


def cv2_resize_linear_f32(image: torch.Tensor, out_w: int, out_h: int) -> torch.Tensor:
    """`cv2.resize(image, (out_w, out_h), interpolation=cv2.INTER_LINEAR)`
    of a float32 (H, W[, C]) image, with OpenCV's float32 weights and
    order of operations."""
    img = image.to(torch.float32)
    squeeze = img.dim() == 2
    if squeeze:
        img = img[..., None]
    h, w, _ = img.shape
    dev = img.device
    if _is_half(h, w, out_h, out_w):
        out = (img[0::2, 0::2] + img[0::2, 1::2] + img[1::2, 0::2] + img[1::2, 1::2]) * 0.25
    else:
        x0, x1, fx = _axis_taps(w, out_w, True)
        a0 = torch.as_tensor(np.float32(1.0) - fx, device=dev)[None, :, None]
        a1 = torch.as_tensor(fx, device=dev)[None, :, None]
        hbuf = (img[:, torch.as_tensor(x0, device=dev)] * a0
                + img[:, torch.as_tensor(x1, device=dev)] * a1)
        y0, y1, fy = _axis_taps(h, out_h, False)
        b0 = torch.as_tensor(np.float32(1.0) - fy, device=dev)[:, None, None]
        b1 = torch.as_tensor(fy, device=dev)[:, None, None]
        out = (hbuf[torch.as_tensor(y0, device=dev)] * b0
               + hbuf[torch.as_tensor(y1, device=dev)] * b1)
    return out[..., 0] if squeeze else out


def cv2_resize_nearest(image: torch.Tensor, out_w: int, out_h: int) -> torch.Tensor:
    """`cv2.resize(image, (out_w, out_h), interpolation=cv2.INTER_NEAREST)`
    of an (H, W[, C]) array of any dtype, on its device: destination index
    d reads source index min(floor(d * (1 / (dst / src))), src - 1), the
    scale in double, as `cv::resize` computes it."""
    h, w = image.shape[:2]
    dev = image.device
    cols = np.minimum(np.floor(np.arange(out_w) * (1.0 / (out_w / w))).astype(np.int64), w - 1)
    rows = np.minimum(np.floor(np.arange(out_h) * (1.0 / (out_h / h))).astype(np.int64), h - 1)
    return image[torch.as_tensor(rows, device=dev)][:, torch.as_tensor(cols, device=dev)]
