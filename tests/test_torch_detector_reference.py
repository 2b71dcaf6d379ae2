"""The port's photo-path detectors against the benchmark's plain float32
reference (`portbench/reference/detector.py`, detectron2's inference
written from its definitions, one image at a time), on the CPU: seeded
person-biased Keypoint R-CNN and PointRend R50-FPN (the benchmark's own
weight recipe, `portbench/detect_inputs.py`, with FrozenBatchNorm away
from the identity), 2 images at 128², 64 proposals, 4 detections and
PointRend's full 5 subdivision steps.

Tolerances and why:
- P2-P6 and the RPN's logits and deltas: 1e-5 of each tensor's largest
  value.  Both sides run the same float32 convolutions; FrozenBatchNorm's
  scale is `w * rsqrt(v + eps)` in the port and `w / sqrt(v + eps)` in
  the reference, an ulp apart, which fifty layers grow to ~1e-6.
- Valid detections: equal in number; boxes within 1e-3 px (float32
  decodes of boxes ~100 px wide round at ~1e-5 px).
- Keypoints within 0.1 px: both decode the same heatmaps (to 1e-5) with
  the same bicubic resize; an argmax would move a whole pixel.
- Mask pixels equal, and the selected proxies equal.
Decisions near a threshold (NMS IoUs, the score threshold, the per-level
top-k cuts) are checked as `tests/torch_margins.py` does, on those that
shape an output only.  The reference's resizes are held bit for bit to
cv2 and Pillow, its NMS to the port's and its ROIAlign to torchvision's
semantics (`tests/torch_twin_d2.py`).
"""

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from portbench import detect_inputs
from portbench.reference import detector as D
from straps_tpu_torch.perception import frontend as TF
from straps_tpu_torch.perception import ops as TO
from straps_tpu_torch.perception import rcnn as TR
from torch_margins import _check_margins
from torch_threads import one_torch_thread  # noqa: F401  (autouse)
from torch_twin_d2 import tv_roi_align

IMG, TOPK, DETS = 128, 64, 4
SEEDS = {"keypoint": 3, "pointrend": 4}
CLASSES = {"keypoint": TR.KeypointRCNN, "pointrend": TR.PointRendRCNN}


def _norms_away_from_identity(state, seed):
    rng = np.random.RandomState(seed)
    ranges = {"norm.running_mean": (-0.3, 0.3), "norm.running_var": (0.7, 1.4),
              "norm.weight": (0.7, 1.3), "norm.bias": (-0.2, 0.2)}
    out = dict(state)
    for k, v in state.items():
        for suffix, (lo, hi) in ranges.items():
            if k.endswith(suffix):
                out[k] = torch.as_tensor(rng.uniform(lo, hi, v.shape).astype(np.float32))
    return out


def _images(seed=0):
    """Two 128² uint8 RGB photos: seeded noise with a bright upright blob."""
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (2, IMG, IMG, 3)).astype(np.uint8)
    imgs[0, 20:110, 45:85] = 230
    imgs[1, 30:120, 30:70] = (200, 120, 60)
    return imgs


@pytest.fixture(scope="module", params=["keypoint", "pointrend"])
def detector(request):
    kind = request.param
    model = TR.init_random_weights(CLASSES[kind](post_nms_topk=TOPK, max_detections=DETS),
                                   torch.Generator().manual_seed(SEEDS[kind]))
    state = detect_inputs.person_biased(_norms_away_from_identity(model.state_dict(),
                                                                  SEEDS[kind] + 100))
    model.load_state_dict(state)
    imgs = _images()
    inputs = torch.cat([D.network_input(img, IMG, "cpu") for img in imgs])
    return kind, model.eval(), state, imgs, inputs


@pytest.mark.parametrize("hw,size", [((480, 640), 512), ((768, 1024), 512), ((96, 128), 64),
                                     ((53, 37), 29)])
def test_reference_resizes_match_cv2_and_pillow(hw, size):
    img = np.random.RandomState(hw[0]).randint(0, 256, hw + (3,)).astype(np.uint8)
    sq = D.pad_to_square(img)
    small = D.cv2_resize_linear(sq, size)
    np.testing.assert_array_equal(small, cv2.resize(sq, (size, size),
                                                    interpolation=cv2.INTER_LINEAR))
    big = 800 if size == 512 else 2 * size + 3
    np.testing.assert_array_equal(D.pil_resize_bilinear(small, big), np.asarray(
        Image.fromarray(small).resize((big, big), Image.BILINEAR)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_nms_matches_the_ports(seed):
    """The textbook loop and the port's blocked fixpoint keep the same boxes
    in the same order, with levels kept apart (by a test and by offsets)."""
    g = torch.Generator().manual_seed(seed)
    xy = torch.rand(300, 2, generator=g) * 100
    boxes = torch.cat([xy, xy + 5 + torch.rand(300, 2, generator=g) * 40], dim=1)
    scores = torch.rand(300, generator=g)
    levels = torch.randint(0, 3, (300,), generator=g)
    want, valid = TO.nms_fixed(boxes + levels[:, None] * 300.0, scores, 0.7, 50)
    got = D.nms(boxes, scores, 0.7, levels, 50)
    np.testing.assert_array_equal(got.numpy(), want[valid].numpy())


@pytest.mark.parametrize("out", [7, 14])
def test_reference_roi_align_matches_torchvision_semantics(out):
    g = torch.Generator().manual_seed(out)
    feat = torch.randn(1, 8, 25, 31, generator=g)
    xy = torch.rand(40, 2, generator=g) * torch.tensor([120.0, 100.0]) - 8
    boxes = torch.cat([xy, xy + torch.rand(40, 2, generator=g) * 90 + 0.3], dim=1)
    want = tv_roi_align(feat, torch.cat([torch.zeros(40, 1), boxes], 1), out, 0.25, 0)
    got = D.roi_align(feat[0], boxes, 0.25, out)
    # The twin places a bin's samples at x1 + (w / out) (k + 0.5) / s,
    # torchvision and the reference at x1 + p w / out + (i + 0.5) (w / out) / s:
    # positions an ulp apart, which move samples of these unit-variance maps by
    # up to ~1e-5.
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-5)


def test_trunk_and_rpn_match_the_reference(detector):
    kind, model, state, _, inputs = detector
    with torch.no_grad():
        feats = model.backbone(inputs)
        logits, deltas = model.proposal_generator.rpn_head(feats)
        for b in range(2):
            ref = D.trunk(inputs[b:b + 1], state)
            for f, r in zip(feats, ref):
                np.testing.assert_allclose(f[b:b + 1].numpy(), r.numpy(), rtol=0,
                                           atol=1e-5 * float(r.abs().max()))
            for lvl, r in enumerate(ref):
                t = torch.relu(D._conv(r, state, "proposal_generator.rpn_head.conv", 1, 1,
                                       norm=False))
                for name, got in (("objectness_logits", logits), ("anchor_deltas", deltas)):
                    want = D._conv(t, state, f"proposal_generator.rpn_head.{name}", norm=False)
                    np.testing.assert_allclose(got[lvl][b:b + 1].numpy(), want.numpy(), rtol=0,
                                               atol=1e-5 * float(want.abs().max()))


def test_whole_detector_matches_the_reference(detector, monkeypatch):
    kind, model, state, _, inputs = detector
    out = _check_margins(monkeypatch, model, inputs)
    for b in range(2):
        valid = out["valid"][b].numpy()
        x = inputs[b:b + 1]
        if kind == "keypoint":
            boxes, kps = D.run_keypoint_rcnn(x, state, TOPK, DETS, out_size=IMG)
        else:
            boxes, masks = D.run_pointrend(x, state, TOPK, DETS, out_size=IMG)
        assert valid.sum() == len(boxes) > 0
        np.testing.assert_allclose(out["boxes"][b].numpy()[valid], boxes.numpy(), atol=1e-3)
        if kind == "keypoint":
            np.testing.assert_allclose(out["keypoints"][b].numpy()[valid], kps.numpy(), atol=0.1)
        else:
            m = out["masks"][b].numpy()[valid]
            assert m.any()
            np.testing.assert_array_equal(m, masks.numpy())


def test_selected_proxies_match_the_reference(detector, monkeypatch):
    """The host selection of the largest centred instance, on the port's
    outputs and on the reference's."""
    kind, model, state, imgs, inputs = detector
    out = _check_margins(monkeypatch, model, inputs)
    host = {k: v.numpy() for k, v in out.items()}
    for b, img in enumerate(imgs):
        x = inputs[b:b + 1]
        if kind == "keypoint":
            boxes, kps = D.run_keypoint_rcnn(x, state, TOPK, DETS, out_size=IMG)
            want = kps[D.largest_centred_box(boxes.numpy(), IMG, IMG)].numpy()
            np.testing.assert_allclose(TF.select_keypoints(host, b, IMG, IMG)[:, :2], want,
                                       atol=0.1)
        else:
            _, masks = D.run_pointrend(x, state, TOPK, DETS, out_size=IMG)
            want = masks[D.largest_centred_mask(masks.numpy(), IMG, IMG)].numpy()
            np.testing.assert_array_equal(TF.select_silhouette(host, b)[0], want)
