"""The benchmark's frozen yardsticks: the chip's published peaks, the
regressor's FLOPs counted from its layer shapes, and the rasteriser
kernels' least time counted from their inputs.

Later changes to the program are judged by these counts, so they depend
only on the configuration and on the kernels' inputs, never on how a
kernel tiles its work.
"""

import torch

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit.
PEAK_BF16_FLOP_S = 989e12
# 67 TFLOP/s of float32 outside the tensor cores, a fused multiply-add
# counting two: 33.5e12 unfused operations a second.
PEAK_FP32_UNFUSED_OPS_S = 33.5e12
HBM_BYTES_S = 3.35e12

# A face's three edge planes `a*x + (b*y + c)`: two unfused operations each.
OPS_PER_PIXEL_FACE = 6

_BLOCKS = {18: ("basic", (2, 2, 2, 2)), 34: ("basic", (3, 4, 6, 3)),
           50: ("bottleneck", (3, 4, 6, 3)), 101: ("bottleneck", (3, 4, 23, 3)),
           152: ("bottleneck", (3, 8, 36, 3))}
IEF_OUTPUTS = 157


def _out(size: int, k: int, s: int, p: int) -> int:
    return (size + 2 * p - k) // s + 1


def _conv_macs(cin: int, cout: int, k: int, s: int, p: int, size: int):
    o = _out(size, k, s, p)
    return cin * cout * k * k * o * o, o


def regressor_macs(depth: int, in_channels: int, img_wh: int, ief_iters: int = 3) -> dict:
    """Multiply-accumulates of one sample's forward pass by part: the
    stem, each of the four stages (downsampling convolutions included) and
    the IEF head.  torchvision's ResNet widths; the IEF head's widths are
    (512, 512) on BasicBlock encoders and (1024, 1024) on Bottleneck ones."""
    kind, layers = _BLOCKS[depth]
    macs, size = _conv_macs(in_channels, 64, 7, 2, 3, img_wh)
    parts = {"stem": macs}
    size = _out(size, 3, 2, 1)                       # max pool
    cin = 64
    for stage, n in enumerate(layers):
        planes = 64 * 2 ** stage
        total = 0
        for b in range(n):
            stride = 2 if stage > 0 and b == 0 else 1
            if kind == "basic":
                cout = planes
                m1, o = _conv_macs(cin, planes, 3, stride, 1, size)
                m2, _ = _conv_macs(planes, planes, 3, 1, 1, o)
                total += m1 + m2
            else:
                cout = planes * 4
                m1, _ = _conv_macs(cin, planes, 1, 1, 0, size)
                m2, o = _conv_macs(planes, planes, 3, stride, 1, size)
                m3, _ = _conv_macs(planes, cout, 1, 1, 0, o)
                total += m1 + m2 + m3
            if stride != 1 or cin != cout:
                total += _conv_macs(cin, cout, 1, stride, 0, size)[0]
            cin, size = cout, o
        parts[f"layer{stage + 1}"] = total
    fc = (512, 512) if kind == "basic" else (1024, 1024)
    parts["ief"] = ief_iters * ((cin + IEF_OUTPUTS) * fc[0] + fc[0] * fc[1]
                                + fc[1] * IEF_OUTPUTS)
    return parts


def regressor_flops(depth: int, in_channels: int, img_wh: int, ief_iters: int = 3,
                    train: bool = False) -> float:
    """FLOPs of one sample: two a multiply-accumulate; a training step
    counts the forward pass three times (forward and backward), with no
    recomputation."""
    flops = 2.0 * sum(regressor_macs(depth, in_channels, img_wh, ief_iters).values())
    return 3.0 * flops if train else flops


def _axis_count(lo: torch.Tensor, hi: torch.Tensor, n: int) -> torch.Tensor:
    """Pixel centres `i + 0.5`, 0 <= i < n, inside [lo, hi]."""
    first = torch.clamp(torch.ceil(lo - 0.5), 0, n)
    last = torch.clamp(torch.floor(hi - 0.5), -1, n - 1)
    return torch.clamp(last - first + 1, min=0)


@torch.no_grad()
def bbox_pixel_faces(flat_planes: torch.Tensor, img_h: int, img_w: int) -> int:
    """(pixel, face) pairs of a launch whose pixel centre lies in the
    face's screen bounding box.  The faces are the kernels' (B, Fp, 12)
    planes (three edges, then depth; each row `[a, b, c]`): each vertex is
    the meeting point of its two edges, and faces whose edges are all
    zero (killed, padding) cover nothing."""
    p = flat_planes.to(torch.float64).reshape(flat_planes.shape[0], -1, 4, 3)
    e = p[:, :, :3]
    live = (e[..., :2].abs().sum(dim=(-1, -2)) > 0)
    verts = []
    for i, j in ((2, 0), (0, 1), (1, 2)):            # vertex k lies on edges k-1 and k
        a1, b1, c1 = e[:, :, i, 0], e[:, :, i, 1], e[:, :, i, 2]
        a2, b2, c2 = e[:, :, j, 0], e[:, :, j, 1], e[:, :, j, 2]
        det = a1 * b2 - a2 * b1
        ok = det.abs() > 0
        det = torch.where(ok, det, torch.ones_like(det))
        live = live & ok
        verts.append(torch.stack([(b1 * c2 - b2 * c1) / det, (a2 * c1 - a1 * c2) / det], -1))
    v = torch.stack(verts, dim=-2)                     # (B, F, 3, 2)
    lo, hi = v.amin(dim=-2), v.amax(dim=-2)
    n = _axis_count(lo[..., 0], hi[..., 0], img_w) * _axis_count(lo[..., 1], hi[..., 1], img_h)
    return int((n * live).sum().item())


def raster_least_time_s(flat_planes: torch.Tensor, bounds_numel: int, attr_bytes: int,
                        img_h: int, img_w: int, out_bytes_per_pixel: int):
    """(least seconds, 'bytes' or 'operations', bytes, operations) of one
    rasteriser launch: each input byte read once (planes, bounds,
    attributes) and each output byte written once, over HBM bandwidth;
    six unfused float32 operations for each (pixel, face) pair of the
    faces' bounding boxes, over the float32 peak."""
    B = flat_planes.shape[0]
    nbytes = (flat_planes.numel() * 4 + bounds_numel * 4 + attr_bytes
              + B * img_h * img_w * out_bytes_per_pixel)
    ops = OPS_PER_PIXEL_FACE * bbox_pixel_faces(flat_planes, img_h, img_w)
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / PEAK_FP32_UNFUSED_OPS_S
    return (t_bytes, "bytes", nbytes, ops) if t_bytes >= t_ops else (t_ops, "operations",
                                                                      nbytes, ops)
