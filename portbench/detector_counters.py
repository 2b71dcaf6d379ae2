"""The photo path's frozen yardstick: the multiply-accumulates of both
R50-FPN detectors at a cell's shapes, counted from their published layer
widths (convolutions and fully connected layers; pooling, resampling,
NMS and the paste count none), and the FLOPs of one predict call.

Keypoint R-CNN and PointRend share the trunk's shapes: ResNet-50 (stride
in the 1x1 convolution), FPN P2-P5 at 256 channels and the RPN head on
P2-P6.  The box head runs on every post-NMS proposal, the mask and
keypoint heads on every detection slot.  PointRend re-predicts
`min(points, S²)` points at each subdivision step at S = 14, 28, ...
except where detectron2 skips a step because the next re-predicts every
point (at 14² with 784 points): 4 x 784 points a detection at 5 steps.
"""

from portbench import counters

FPN_DIM, RPN_ANCHORS, BOX_FC, POOL = 256, 3, 1024, 7
KEYPOINT_CONVS, KEYPOINT_DIM, KEYPOINT_ROI, KEYPOINTS = 8, 512, 14, 17
POINT_FC, POINT_LAYERS = 256, 3


def conv_macs(cin: int, cout: int, k: int, out_h: int, out_w: int = None) -> int:
    return cin * cout * k * k * out_h * (out_h if out_w is None else out_w)


def linear_macs(cin: int, cout: int) -> int:
    return cin * cout


def deconv_macs(cin: int, cout: int, k: int, in_h: int) -> int:
    """A transposed convolution: every input position meets every tap."""
    return cin * cout * k * k * in_h * in_h


def trunk_macs(size: int) -> dict:
    """Backbone, FPN and RPN head of one image at `size`²."""
    s = counters._out(size, 7, 2, 3)
    parts = {"stem": conv_macs(3, 64, 7, s)}
    s = counters._out(s, 3, 2, 1)
    cin, sizes = 64, []
    for stage, n in enumerate((3, 4, 6, 3)):
        width, total = 64 * 2 ** stage, 0
        for b in range(n):
            stride = 2 if stage > 0 and b == 0 else 1
            o = counters._out(s, 1, stride, 0)
            total += conv_macs(cin, width, 1, o) + conv_macs(width, width, 3, o)
            total += conv_macs(width, 4 * width, 1, o)
            if b == 0:
                total += conv_macs(cin, 4 * width, 1, o)
            cin, s = 4 * width, o
        parts[f"res{stage + 2}"] = total
        sizes.append(s)
    parts["fpn"] = sum(conv_macs(256 * 2 ** i, FPN_DIM, 1, o) + conv_macs(FPN_DIM, FPN_DIM, 3, o)
                       for i, o in enumerate(sizes))
    sizes.append(counters._out(sizes[-1], 1, 2, 0))
    parts["rpn"] = sum(conv_macs(FPN_DIM, FPN_DIM, 3, o)
                       + conv_macs(FPN_DIM, RPN_ANCHORS * 5, 1, o) for o in sizes)
    return parts


def box_head_macs(proposals: int, num_classes: int) -> int:
    per = (linear_macs(FPN_DIM * POOL * POOL, BOX_FC) + linear_macs(BOX_FC, BOX_FC)
           + linear_macs(BOX_FC, num_classes + 1) + linear_macs(BOX_FC, 4 * num_classes))
    return proposals * per


def keypoint_head_macs(detections: int) -> int:
    r = KEYPOINT_ROI
    per = conv_macs(FPN_DIM, KEYPOINT_DIM, 3, r)
    per += (KEYPOINT_CONVS - 1) * conv_macs(KEYPOINT_DIM, KEYPOINT_DIM, 3, r)
    per += deconv_macs(KEYPOINT_DIM, KEYPOINTS, 4, r)
    return detections * per


def subdivision_points(steps: int, points: int, side: int = POOL) -> int:
    total = 0
    for step in range(steps):
        side *= 2
        if points >= 4 * side * side and step < steps - 1:
            continue
        total += min(points, side * side)
    return total


def pointrend_head_macs(detections: int, num_classes: int, steps: int, points: int) -> int:
    coarse = (conv_macs(FPN_DIM, FPN_DIM, 2, POOL) + linear_macs(FPN_DIM * POOL * POOL, BOX_FC)
              + linear_macs(BOX_FC, BOX_FC) + linear_macs(BOX_FC, num_classes * POOL * POOL))
    point = (POINT_LAYERS * linear_macs(POINT_FC + num_classes, POINT_FC)
             + linear_macs(POINT_FC + num_classes, num_classes))
    return detections * (coarse + subdivision_points(steps, points) * point)


def detector_macs(det: dict) -> dict:
    """One image through both detectors, by part, for a configuration's
    `detectors` block."""
    trunk = sum(trunk_macs(int(det["test_size"])).values())
    topk, dets = int(det["post_nms_topk"]), int(det["max_detections"])
    kp, pr = det["keypoint_rcnn"], det["pointrend"]
    return {"trunks": 2 * trunk,
            "box_heads": box_head_macs(topk, kp["num_classes"])
            + box_head_macs(topk, pr["num_classes"]),
            "keypoint_head": keypoint_head_macs(dets),
            "pointrend_heads": pointrend_head_macs(dets, pr["num_classes"],
                                                   pr["subdivision_steps"],
                                                   pr["subdivision_points"])}


def predict_call_flops(cfg: dict, images: int) -> float:
    """FLOPs of one predict call over `images` photos: both detectors and
    the regressor, two a multiply-accumulate."""
    det = dict(cfg["detectors"], post_nms_topk=cfg["detector_post_nms_topk"],
               max_detections=cfg["detector_max_detections"])
    m = cfg["model"]
    return images * (2.0 * sum(detector_macs(det).values()) + counters.regressor_flops(
        m["resnet_layers"], m["resnet_in_channels"], cfg["img_wh"], m["ief_iters"]))
