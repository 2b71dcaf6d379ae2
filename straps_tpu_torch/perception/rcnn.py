"""Generalized R-CNN compositions: Keypoint-RCNN and PointRend-RCNN on a
ResNet-50 FPN trunk, DensePose-RCNN on a ResNet-101 FPN trunk (counterpart
of `straps_tpu/perception/rcnn.py`).

detectron2's module tree and state-dict names (`backbone.*`,
`proposal_generator.rpn_head.*`, `roi_heads.{box_head,box_predictor,
keypoint_head,mask_coarse_head,mask_point_head,densepose_head,
densepose_predictor}.*`).  A forward takes a
batch of normalised images: the backbone, the FPN and the RPN head run on
the whole batch; proposals, NMS, detections and the ROI heads are each
image's own, with static counts and validity masks.
"""

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from straps_tpu_torch.perception.anchors import fpn_anchors
from straps_tpu_torch.perception.densepose import (
    DensePosePredictor, DensePoseV1ConvXHead, densepose_to_iuv, paste_part_labels,
)
from straps_tpu_torch.perception.fpn import FPN_STRIDES, FPNBackbone, FrozenBatchNorm2d
from straps_tpu_torch.perception.heads import (
    FastRCNNConvFCHead, FastRCNNOutputLayers, KRCNNConvDeconvUpsampleHead, box_inference,
    keypoint_decode, pooled_box_features,
)
from straps_tpu_torch.perception.ops import roi_align
from straps_tpu_torch.perception.pointrend import (
    CoarseMaskHead, StandardPointHead, paste_mask, subdivision_inference,
)
from straps_tpu_torch.perception.rpn import RPNHead, generate_proposals
from straps_tpu_torch.utils.profiling import span

# detectron2's COCO pixel normalisation (BGR mean, std 1 for the R50 models).
PIXEL_MEAN = np.asarray([103.53, 116.28, 123.675], np.float32)
PIXEL_STD = np.asarray([1.0, 1.0, 1.0], np.float32)

# The reference resizes its inputs to 512 before the detectors
# (`predict_3D.py:106`); detectron2's predictor resizes to MIN_SIZE_TEST=800
# before the network, and the outputs are mapped back to the 512 frame.
DEFAULT_IMAGE_SIZE = 512
DETECTOR_TEST_SIZE = 800
# Smaller than detectron2's 1000 proposals and 100 detections: STRAPS uses
# one largest centred person (PARITY.md).
MAX_DETECTIONS = 8
POST_NMS_TOPK = 512

_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


class _Scope(nn.Module):
    """A named container, so that state-dict names match detectron2's."""


class _DetectorBase(nn.Module):
    """Backbone + RPN + box head, shared by the three models.  Boxes,
    keypoints and masks come back in an `output_size` frame (0: the
    input's).  The box pooler is detectron2's ROIAlignV2 with adaptive
    sampling (`box_pooler_aligned=True`, `box_pooler_sampling_ratio=0`,
    the Keypoint-RCNN and PointRend configs) or the legacy ROIAlign at a
    fixed ratio (DensePose: False, 2)."""

    def __init__(self, num_classes: int, post_nms_topk: int = POST_NMS_TOPK,
                 max_detections: int = MAX_DETECTIONS, output_size: int = 0,
                 backbone_dtype: Optional[str] = None, score_thresh: float = 0.05,
                 backbone_depth: int = 50, box_pooler_aligned: bool = True,
                 box_pooler_sampling_ratio: int = 0):
        super().__init__()
        self.post_nms_topk, self.max_detections = post_nms_topk, max_detections
        self.output_size, self.score_thresh = output_size, score_thresh
        self.box_pooler_aligned = box_pooler_aligned
        self.box_pooler_sampling_ratio = box_pooler_sampling_ratio
        if backbone_dtype is not None and backbone_dtype not in _DTYPES:
            raise ValueError(f"backbone_dtype must be 'float32', 'bfloat16' or None, "
                             f"got {backbone_dtype!r}")
        self.compute_dtype = _DTYPES.get(backbone_dtype)
        self.backbone = FPNBackbone(backbone_depth)
        self.proposal_generator = _Scope()
        self.proposal_generator.rpn_head = RPNHead()
        self.roi_heads = _Scope()
        self.roi_heads.box_head = FastRCNNConvFCHead()
        self.roi_heads.box_predictor = FastRCNNOutputLayers(num_classes=num_classes)

    def trunk(self, images: torch.Tensor):
        """images: (B, 3, S, S) normalised BGR.  Returns the P2-P5 features
        channels-last [(B, H, W, 256)], and the detections: (B, D, 4) boxes
        in the input frame, (B, D) scores and validity."""
        B, _, img_size, _ = images.shape
        with span("straps.detect.trunk"), torch.autocast(
                images.device.type, dtype=self.compute_dtype or torch.bfloat16,
                enabled=self.compute_dtype is not None):
            feats = self.backbone(images)
        with span("straps.detect.proposals"):
            logits, deltas = self.proposal_generator.rpn_head(feats)
            anchors = fpn_anchors(img_size, FPN_STRIDES,
                                  feat_sizes=[f.shape[-2:] for f in feats])
            proposals, _, p_valid = generate_proposals(logits, deltas, anchors, img_size,
                                                       post_nms_topk=self.post_nms_topk)
        with span("straps.detect.box"):
            nhwc = [f.permute(0, 2, 3, 1).contiguous() for f in feats[:4]]
            roi = pooled_box_features(nhwc, proposals, 7, aligned=self.box_pooler_aligned,
                                      sampling_ratio=self.box_pooler_sampling_ratio,
                                      compute_dtype=self.compute_dtype)
            scores, box_deltas = self.roi_heads.box_predictor(self.roi_heads.box_head(roi))
            P = proposals.shape[1]
            boxes, det_scores, valid = box_inference(
                scores.view(B, P, -1), box_deltas.view(B, P, -1), proposals, p_valid, img_size,
                score_thresh=self.score_thresh, max_detections=self.max_detections)
        return nhwc, boxes, det_scores, valid

    def _out_frame(self, images: torch.Tensor):
        out_size = self.output_size or images.shape[-1]
        return out_size, out_size / images.shape[-1]


class KeypointRCNN(_DetectorBase):
    """Person detection + 17 COCO keypoints (the reference's Keypoint-RCNN
    R50-FPN, `predict/predict_joints2D.py`)."""

    def __init__(self, **kwargs):
        super().__init__(num_classes=1, **kwargs)
        self.roi_heads.keypoint_head = KRCNNConvDeconvUpsampleHead()

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        nhwc, boxes, scores, valid = self.trunk(images)
        B, D = valid.shape
        with span("straps.detect.keypoint_head"):
            heatmaps = self.roi_heads.keypoint_head(
                pooled_box_features(nhwc, boxes, 14, compute_dtype=self.compute_dtype))
            out_size, scale = self._out_frame(images)
            out_boxes = boxes * scale
            kp, kp_scores = keypoint_decode(heatmaps, out_boxes.reshape(B * D, 4), out_size)
        return {"boxes": out_boxes, "scores": scores, "valid": valid,
                "keypoints": kp.view(B, D, -1, 2), "keypoint_scores": kp_scores.view(B, D, -1)}


class PointRendRCNN(_DetectorBase):
    """Person detection + PointRend instance masks (the reference's
    PointRend R50-FPN, `predict/predict_silhouette_pointrend.py`): 80
    classes, person = 0; coarse features are P2 sampled on a regular 14x14
    box grid (zero padding); subdivision refines the person channel only."""

    def __init__(self, num_classes: int = 80, **kwargs):
        super().__init__(num_classes=num_classes, **kwargs)
        self.roi_heads.mask_coarse_head = CoarseMaskHead(num_classes=num_classes)
        self.roi_heads.mask_point_head = StandardPointHead(num_classes=num_classes)

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        nhwc, boxes, scores, valid = self.trunk(images)
        B, D = valid.shape
        with span("straps.detect.mask"):
            mask_roi = roi_align(nhwc[0], boxes, 1.0 / FPN_STRIDES[0], 14, sampling_ratio=1,
                                 mode="zeros")                              # (B, D, 14, 14, C)
            coarse = self.roi_heads.mask_coarse_head(
                mask_roi.reshape(B * D, 14, 14, -1).permute(0, 3, 1, 2))
            image_index = torch.arange(B, device=images.device).repeat_interleave(D)
            refined = subdivision_inference(self.roi_heads.mask_point_head, coarse, nhwc[0],
                                            boxes.reshape(B * D, 4), image_index, channel=0)
            out_size, scale = self._out_frame(images)
            out_boxes = boxes * scale
            masks = paste_mask(refined[:, 0], out_boxes.reshape(B * D, 4), out_size, out_size)
        return {"boxes": out_boxes, "scores": scores, "valid": valid,
                "masks": masks.view(B, D, out_size, out_size)}


class DensePoseRCNN(_DetectorBase):
    """Person detection + DensePose IUV (the reference's DensePose-RCNN
    R101-FPN, `predict/predict_densepose.py`, detectron2's
    `densepose_rcnn_R_101_FPN_s1x`): the legacy ratio-2 box pooler, the
    DensePose pooler at 14x14 (legacy, ratio 2), the V1ConvX head and the
    four-branch predictor at 56x56, the IUV selection per ROI, and each
    detection's part labels pasted into the `output_size` frame
    (`paste_part_labels`).  `masks` is `part_map > 0`, the binary
    silhouette STRAPS consumes; `part_map` (uint8) is returned too with
    `output_part_maps`."""

    def __init__(self, backbone_depth: int = 101, output_part_maps: bool = False, **kwargs):
        super().__init__(num_classes=1, backbone_depth=backbone_depth, box_pooler_aligned=False,
                         box_pooler_sampling_ratio=2, **kwargs)
        self.output_part_maps = output_part_maps
        self.roi_heads.densepose_head = DensePoseV1ConvXHead()
        self.roi_heads.densepose_predictor = DensePosePredictor()

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        nhwc, boxes, scores, valid = self.trunk(images)
        B, D = valid.shape
        roi = pooled_box_features(nhwc, boxes, 14, aligned=False, sampling_ratio=2,
                                  compute_dtype=self.compute_dtype)
        s, i, u, v = self.roi_heads.densepose_predictor(self.roi_heads.densepose_head(roi))
        part, u_sel, v_sel = densepose_to_iuv(s, i, u, v)
        out_size, scale = self._out_frame(images)
        out_boxes = boxes * scale
        part_map = paste_part_labels(s, i, out_boxes.reshape(B * D, 4), out_size, out_size)
        part_map = part_map.view(B, D, out_size, out_size)
        S = part.shape[-1]
        out = {"boxes": out_boxes, "scores": scores, "valid": valid, "masks": part_map > 0,
               "part_index": part.view(B, D, S, S), "u": u_sel.view(B, D, S, S),
               "v": v_sel.view(B, D, S, S)}
        if self.output_part_maps:
            out["part_map"] = part_map
        return out


# detectron2's initial standard deviations of the prediction layers (the
# RPN convs, the box predictor, the mask predictors); other weights get
# variance 1/fan_in.
_INIT_STD = {"proposal_generator.rpn_head": 0.01, "roi_heads.box_predictor.cls_score": 0.01,
             "roi_heads.box_predictor.bbox_pred": 0.001,
             "roi_heads.mask_coarse_head.prediction": 0.001,
             "roi_heads.mask_point_head.predictor": 0.001}


def init_random_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights (on the CPU): detectron2's small normal
    initialisation of the prediction layers (`_INIT_STD`), other
    convolution and linear weights normal with variance 1/fan_in, biases 0,
    FrozenBatchNorm the identity.  Materialises a model built on the `meta`
    device."""
    if any(t.is_meta for t in list(model.parameters()) + list(model.buffers())):
        model.to_empty(device="cpu")
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                w = m.weight
                fan_in = w.numel() // w.shape[1 if isinstance(m, nn.ConvTranspose2d) else 0]
                std = next((s for p, s in _INIT_STD.items() if name.startswith(p)),
                           fan_in ** -0.5)
                w.copy_(torch.randn(w.shape, generator=generator) * std)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, FrozenBatchNorm2d):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
    return model


def normalise_image(image_rgb: np.ndarray) -> np.ndarray:
    """uint8 RGB (H, W, 3) -> normalised BGR float32 (H, W, 3), on the host."""
    bgr = np.asarray(image_rgb, np.float32)[..., ::-1]
    return (bgr - PIXEL_MEAN) / PIXEL_STD


def normalise_image_device(images_rgb: torch.Tensor) -> torch.Tensor:
    """uint8 RGB (B, H, W, 3) on any device -> the detectors' input, the
    normalised BGR float32 (B, 3, H, W) on the same device: the batch
    crosses to the card as uint8."""
    bgr = images_rgb.to(torch.float32).flip(-1)
    mean = torch.as_tensor(PIXEL_MEAN, device=bgr.device)
    std = torch.as_tensor(PIXEL_STD, device=bgr.device)
    return ((bgr - mean) / std).permute(0, 3, 1, 2)
