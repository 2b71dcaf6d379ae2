"""The rasterisers' CUDA kernels, their wrappers and their plain PyTorch
versions.

Counterparts of `rasterize_pallas` in `straps_tpu/render/pallas_raster.py`:

* attribute-packed (`rasterize_packed`, `face_attr` given): per pixel the
  minimum over covered faces of the int32 key `(bits(z) & ~7) | attr`.
  Positive floats order like their bit patterns, so one integer min
  resolves the depth test and the attribute lookup.  The attribute map is
  `key & 7` (0 = background), the depth `bits^-1(key & ~7)`, quantised to
  8 ulps.  Kernel: `csrc/raster_packed.cu`.
* face-id (`rasterize_faceid`): per pixel the covered face of least depth,
  the smallest face id on a depth tie, and its exact depth (-1 and 3.4e38
  where background).  Kernel: `csrc/raster_faceid.cu`.

Both kernels are per-row span scans over one shared header,
`csrc/raster_span.cuh`; the plain versions here evaluate every pixel of
every chunk's band densely and are the definition both are held to.

Each takes the tensor's device as the rule: a CUDA tensor goes through the
kernel (built with nvcc at first use) or the call raises; a CPU tensor goes
through the plain version.
"""

import ctypes
import weakref
from typing import Tuple

import numpy as np
import torch

from straps_tpu_torch.render.raster import pad_face_planes
from straps_tpu_torch.utils import native_build

FACE_CHUNK = 128          # faces per chunk; the kernels' bounds granularity
ROWS_PER_TILE = 8         # pixel rows of one kernel block
ATTR_BITS = 3
_ATTR_MASK = (1 << ATTR_BITS) - 1
# Background depth of the face-id rasteriser (the TPU kernel's `big`).
FACEID_BG_DEPTH = 3.4e38
# Background key: the largest finite depth bucket with attribute 0.
PACKED_INIT = int(np.float32(FACEID_BG_DEPTH).view(np.int32)) & ~_ATTR_MASK
# Bytes of one (sub-batch, chunk, rows, W) temporary of a plain version.
_PLAIN_TEMP_BYTES = 1 << 28


def _check(img_h: int, img_w: int, **inputs):
    """Raise ValueError unless `inputs` ({name: (tensor, dtype, shape)},
    `planes` among them) are contiguous, of their dtype and shape, on one
    CUDA device, with faces padded to FACE_CHUNK and the planes and
    attributes 16-byte aligned (the kernels stage them with bulk copies)."""
    planes = inputs["planes"][0]
    B, Fp = planes.shape[:2]
    dev = planes.device
    for name, (t, dtype, shape) in inputs.items():
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"{name}: want contiguous {dtype} {shape} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()})")
    misaligned = any(inputs[n][0].data_ptr() % 16 for n in ("planes", "attr") if n in inputs)
    if dev.type != "cuda" or Fp % FACE_CHUNK or misaligned:
        raise ValueError(f"kernel needs CUDA tensors, faces padded to "
                         f"{FACE_CHUNK} and 16-byte aligned planes and attributes")
    if not (0 < img_h and 0 < img_w and B < 65536):
        raise ValueError(f"bad launch shape B={B} H={img_h} W={img_w}")


class _PackedRasterKernel(native_build.CudaKernels):
    def __init__(self):
        super().__init__("raster_packed.cu",
                         {"raster_packed_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5})

    def __call__(self, planes: torch.Tensor, bounds: torch.Tensor,
                 attr: torch.Tensor, img_h: int, img_w: int) -> torch.Tensor:
        """planes (B, Fp, 12) f32, bounds (B, Fp/128, 2) int32, attr (Fp,)
        int32, all contiguous on one CUDA device -> (B, H, W) int32 keys."""
        B, Fp = planes.shape[:2]
        _check(img_h, img_w,
               planes=(planes, torch.float32, (B, Fp, 12)),
               bounds=(bounds, torch.int32, (B, Fp // FACE_CHUNK, 2)),
               attr=(attr, torch.int32, (Fp,)))
        out = torch.empty((B, img_h, img_w), dtype=torch.int32, device=planes.device)
        self.launch("raster_packed_launch", planes.device, bounds, planes, attr, out, B,
                    Fp // FACE_CHUNK, img_h, img_w, PACKED_INIT)
        return out


class _FaceIdRasterKernel(native_build.CudaKernels):
    def __init__(self):
        super().__init__("raster_faceid.cu",
                         {"raster_faceid_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                                                  + [ctypes.c_float]})

    def __call__(self, planes: torch.Tensor, bounds: torch.Tensor,
                 img_h: int, img_w: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """planes (B, Fp, 12) f32, bounds (B, Fp/128, 2) int32, contiguous
        on one CUDA device -> face ids (B, H, W) int32, depth (B, H, W) f32."""
        B, Fp = planes.shape[:2]
        _check(img_h, img_w,
               planes=(planes, torch.float32, (B, Fp, 12)),
               bounds=(bounds, torch.int32, (B, Fp // FACE_CHUNK, 2)))
        fid = torch.empty((B, img_h, img_w), dtype=torch.int32, device=planes.device)
        depth = torch.empty((B, img_h, img_w), dtype=torch.float32, device=planes.device)
        self.launch("raster_faceid_launch", planes.device, bounds, planes, fid, depth, B,
                    Fp // FACE_CHUNK, img_h, img_w, FACEID_BG_DEPTH)
        return fid, depth


packed_raster_kernel = _PackedRasterKernel()
faceid_raster_kernel = _FaceIdRasterKernel()


def _plane_eval(p: torch.Tensor, k: int, xs: torch.Tensor,
                y: torch.Tensor) -> torch.Tensor:
    """Plane columns k, k+1, k+2 of (B, C, 12) planes at pixel centres
    (R, 1) x (W,) -> (B, C, R, W), as `a*x + (b*y + c)` with each product
    and sum rounded on its own, as the kernels do."""
    a = p[:, :, k, None, None] * xs
    b = p[:, :, k + 1, None, None] * y + p[:, :, k + 2, None, None]
    return a + b


def _band_chunks(bounds: torch.Tensor):
    """(chunk, lo, hi) of every chunk whose row band, united over the
    batch, is not empty.  Rows outside every batch element's band of a
    chunk cannot be covered by its faces (the bands come from the faces'
    vertex y-extent), so a plain version evaluates only those rows."""
    lo_all = bounds[..., 0].amin(dim=0).tolist()
    hi_all = bounds[..., 1].amax(dim=0).tolist()
    return [(c, lo, hi) for c, (lo, hi) in enumerate(zip(lo_all, hi_all)) if lo < hi]


def _pixel_centres(img_h: int, img_w: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    xs = torch.arange(img_w, dtype=torch.float32, device=device) + 0.5
    ys = torch.arange(img_h, dtype=torch.float32, device=device) + 0.5
    return xs, ys


def rasterize_packed_reference(planes: torch.Tensor, bounds: torch.Tensor,
                               attr: torch.Tensor, img_h: int,
                               img_w: int) -> torch.Tensor:
    """Plain PyTorch version of the packed kernel: same arguments, same
    keys.  Each chunk is evaluated over the union of its row bands, every
    pixel of every batch element inside it.  The batch is taken in
    sub-batches that keep each temporary under 256 MB (each element's keys
    depend on its own planes only)."""
    B = planes.shape[0]
    sub = max(1, _PLAIN_TEMP_BYTES // (FACE_CHUNK * img_h * img_w * 4))
    if B > sub:
        return torch.cat([rasterize_packed_reference(planes[s:s + sub], bounds[s:s + sub],
                                                     attr, img_h, img_w)
                          for s in range(0, B, sub)])
    xs, ys = _pixel_centres(img_h, img_w, planes.device)
    key = torch.full((B, img_h, img_w), PACKED_INIT, dtype=torch.int32, device=planes.device)
    for c, lo, hi in _band_chunks(bounds):
        p = planes[:, c * FACE_CHUNK:(c + 1) * FACE_CHUNK]          # (B, C, 12)
        y = ys[lo:hi][:, None]                                       # (R, 1)
        cov = torch.minimum(torch.minimum(_plane_eval(p, 0, xs, y),
                                          _plane_eval(p, 3, xs, y)),
                            _plane_eval(p, 6, xs, y)) >= 0
        zbits = _plane_eval(p, 9, xs, y).view(torch.int32)
        pk = (zbits & ~_ATTR_MASK) | attr[c * FACE_CHUNK:(c + 1) * FACE_CHUNK, None, None]
        pk = torch.where(cov, pk, PACKED_INIT).amin(dim=1)            # (B, R, W)
        key[:, lo:hi] = torch.minimum(key[:, lo:hi], pk)
    return key


def rasterize_faceid_reference(planes: torch.Tensor, bounds: torch.Tensor,
                               img_h: int, img_w: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the face-id kernel, as the TPU kernel
    `_raster_kernel` computes it: within a chunk, the min depth over
    covered faces and its first argmin; across chunks, an update on strict
    `<`.  So on a depth tie the smallest face id wins.  Returns face ids
    (B, H, W) int32 (-1 where background) and depth (B, H, W) f32
    (3.4e38 where background).  The batch is taken in sub-batches that
    keep each temporary under 256 MB."""
    B = planes.shape[0]
    sub = max(1, _PLAIN_TEMP_BYTES // (FACE_CHUNK * img_h * img_w * 4))
    if B > sub:
        parts = [rasterize_faceid_reference(planes[s:s + sub], bounds[s:s + sub],
                                            img_h, img_w) for s in range(0, B, sub)]
        return torch.cat([f for f, _ in parts]), torch.cat([z for _, z in parts])
    xs, ys = _pixel_centres(img_h, img_w, planes.device)
    best_z = torch.full((B, img_h, img_w), FACEID_BG_DEPTH, dtype=torch.float32,
                        device=planes.device)
    best_f = torch.full((B, img_h, img_w), -1, dtype=torch.int32, device=planes.device)
    for c, lo, hi in _band_chunks(bounds):
        p = planes[:, c * FACE_CHUNK:(c + 1) * FACE_CHUNK]
        y = ys[lo:hi][:, None]
        cov = torch.minimum(torch.minimum(_plane_eval(p, 0, xs, y),
                                          _plane_eval(p, 3, xs, y)),
                            _plane_eval(p, 6, xs, y)) >= 0
        zed = torch.where(cov, _plane_eval(p, 9, xs, y), FACEID_BG_DEPTH)
        zmin = zed.amin(dim=1)                                        # (B, R, W)
        amin = zed.argmin(dim=1).to(torch.int32) + c * FACE_CHUNK
        better = zmin < best_z[:, lo:hi]
        best_z[:, lo:hi] = torch.where(better, zmin, best_z[:, lo:hi])
        best_f[:, lo:hi] = torch.where(better, amin, best_f[:, lo:hi])
    return best_f, best_z


def unpack_keys(key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int32 keys -> (attribute map int32, depth f32)."""
    return key & _ATTR_MASK, (key & ~_ATTR_MASK).view(torch.float32)


def flatten_planes(planes: torch.Tensor) -> torch.Tensor:
    """(B, F, 4, 3) planes -> the kernels' contiguous (B, Fp, 12) f32
    planes, padded with never-covered faces to a multiple of FACE_CHUNK."""
    planes = pad_face_planes(planes.to(torch.float32), FACE_CHUNK)
    return planes.reshape(planes.shape[0], planes.shape[1], 12).contiguous()


# Attribute tensors found in range, by (id, data pointer, version); an
# entry lives as long as its tensor.
_ATTR_IN_RANGE: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()


def _check_attr_range(face_attr: torch.Tensor) -> None:
    """Raise ValueError on an attribute outside [0, 8): the kernel ORs it
    into the key's low bits, where a wider value would corrupt the depth.
    The check reads the values on the host, so it runs once for each
    tensor, storage and version: `_version` advances at every in-place
    write through the tensor or a view of it, not at a write that bypasses
    autograd's counter (through `.data`, DLPack or another library), which
    this check does not see.  An inference tensor, which keeps no version,
    is checked at every call."""
    key = None if face_attr.is_inference() else (id(face_attr), face_attr.data_ptr(),
                                                 face_attr._version)
    if key is not None and _ATTR_IN_RANGE.get(key) is face_attr:
        return
    lo, hi = torch.stack(torch.aminmax(face_attr)).tolist() if face_attr.numel() else (0, 0)
    if lo < 0 or hi > _ATTR_MASK:
        raise ValueError(f"face_attr must lie in [0, {_ATTR_MASK}], got [{lo}, {hi}]")
    if key is not None:
        _ATTR_IN_RANGE[key] = face_attr


def pack_planes(planes: torch.Tensor, face_attr: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, F, 4, 3) planes + (F,) attributes -> the packed kernel's inputs:
    `flatten_planes(planes)` and (Fp,) int32 attributes (0 on padding).
    Raises ValueError on an attribute outside [0, 8) (`_check_attr_range`)."""
    _check_attr_range(face_attr)
    flat = flatten_planes(planes)
    attr = torch.zeros((flat.shape[1],), dtype=torch.int32, device=flat.device)
    attr[:face_attr.shape[0]] = face_attr.to(torch.int32)
    return flat, attr


def _device_rule(device: torch.device, name: str) -> bool:
    """True for CUDA (the kernel), False for the CPU (the plain version);
    ValueError for any other device."""
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"no {name} rasteriser for device {device}")
    return device.type == "cuda"


def rasterize_packed(planes: torch.Tensor, bounds: torch.Tensor,
                     face_attr: torch.Tensor, img_h: int, img_w: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rasterise plane-form faces to (attribute map, depth).

    Args:
      planes: (B, F, 4, 3) from `prepare_face_planes`.
      bounds: (B, ceil(F / 128), 2) int32 from `face_chunk_row_bounds` with
        chunk=FACE_CHUNK.
      face_attr: (F,) int attribute per face in [0, 8) (0 = background).
        Depths must be positive.
    Returns:
      attribute map (B, H, W) int32 (0 = background) and depth (B, H, W)
      f32 quantised to 8 ulps (3.4e38 where background).
    """
    flat, attr = pack_planes(planes, face_attr)
    bounds = bounds.to(torch.int32).contiguous()
    if _device_rule(flat.device, "packed"):
        key = packed_raster_kernel(flat, bounds, attr, img_h, img_w)
    else:
        key = rasterize_packed_reference(flat, bounds, attr, img_h, img_w)
    return unpack_keys(key)


def rasterize_faceid(planes: torch.Tensor, bounds: torch.Tensor,
                     img_h: int, img_w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rasterise plane-form faces to (face-id map, depth).

    Args:
      planes: (B, F, 4, 3) from `prepare_face_planes`.
      bounds: (B, ceil(F / 128), 2) int32 from `face_chunk_row_bounds` with
        chunk=FACE_CHUNK.
    Returns:
      face ids (B, H, W) int32 (-1 = background; the smallest id on a
      depth tie) and exact depth (B, H, W) f32 (3.4e38 where background).
    """
    flat = flatten_planes(planes)
    bounds = bounds.to(torch.int32).contiguous()
    if _device_rule(flat.device, "face-id"):
        return faceid_raster_kernel(flat, bounds, img_h, img_w)
    return rasterize_faceid_reference(flat, bounds, img_h, img_w)
