"""The detector front end of the PyTorch port (`straps_tpu_torch/perception/`)
against the JAX package's, on the same numpy inputs and the same weights:
the port's seeded detectors (detectron2 names, FrozenBN statistics drawn at
random) go to the JAX models through the JAX package's own `convert_d2_state`.

Tolerances are those of `tests/test_perception_parity.py`: FPN features
2e-3 of each level's largest value, RPN outputs and ROIAlign 1e-4 (relative,
or 1e-6 of the largest value on pooled FPN maps, whose values reach
hundreds), head outputs atol 5e-4 / rtol 1e-3, boxes 0.1 px, keypoints 2e-3
px on the same heatmaps, masks and refined grids by the share of equal
pixels.  Where a
test runs a whole detector, it first shows that its seed takes no decision
(a score threshold, an NMS IoU, a top-k cut) within 1e-4 of its threshold.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from straps_tpu.perception import DensePoseRCNN as JDensePoseRCNN
from straps_tpu.perception import KeypointRCNN as JKeypointRCNN
from straps_tpu.perception import PointRendRCNN as JPointRendRCNN
from straps_tpu.perception import anchors as JA
from straps_tpu.perception import convert_d2_state, load_d2_pkl as jax_load_d2_pkl
from straps_tpu.perception import heads as JH
from straps_tpu.perception import ops as JO
from straps_tpu.perception import pointrend as JPR
from straps_tpu.perception.fpn import ResNet50FPN
from straps_tpu.perception.rpn import RPNHead as JRPNHead, generate_proposals as j_proposals
from straps_tpu_torch.perception import anchors as TA
from straps_tpu_torch.perception import heads as TH
from straps_tpu_torch.perception import ops as TO
from straps_tpu_torch.perception import pointrend as TPR
from straps_tpu_torch.perception import rcnn as TR
from straps_tpu_torch.perception import rpn as TRPN
from straps_tpu_torch.perception.convert_d2 import (
    flax_detector_to_torch_state_dict, load_d2_pkl, load_detector_state, save_d2_pkl,
)
from torch_margins import MARGIN, _check_margins
from torch_threads import one_torch_thread  # noqa: F401  (autouse)
from torch_twin_d2 import tv_roi_align

IMG = 128
TOPK = 64
DETS = 4


def _randomise_norms(state, seed):
    """FrozenBN affines and statistics away from the identity, so the norm
    arithmetic and its name routing are exercised."""
    rng = np.random.RandomState(seed)
    ranges = {"norm.running_mean": (-0.3, 0.3), "norm.running_var": (0.7, 1.4),
              "norm.weight": (0.7, 1.3), "norm.bias": (-0.2, 0.2)}
    out = dict(state)
    for k, v in state.items():
        for suffix, (lo, hi) in ranges.items():
            if k.endswith(suffix):
                out[k] = torch.as_tensor(rng.uniform(lo, hi, v.shape).astype(np.float32))
    return out


def person_biased(state, cls_bias=4.0, mask_bias=1.5):
    """Random detectors that find people: the person logit raised, and the
    person masks' coarse and point predictions raised, so that detections
    and masks are not a coin toss at their thresholds."""
    out = dict(state)
    b = out["roi_heads.box_predictor.cls_score.bias"].clone()
    b[0] += cls_bias
    out["roi_heads.box_predictor.cls_score.bias"] = b
    if "roi_heads.mask_coarse_head.prediction.bias" in out:
        b = out["roi_heads.mask_coarse_head.prediction.bias"].clone()
        b[:49] += mask_bias
        out["roi_heads.mask_coarse_head.prediction.bias"] = b
        b = out["roi_heads.mask_point_head.predictor.bias"].clone()
        b[0] += mask_bias
        out["roi_heads.mask_point_head.predictor.bias"] = b
    return out


def _detector(cls, seed, **kw):
    model = TR.init_random_weights(cls(post_nms_topk=TOPK, max_detections=DETS, **kw),
                                   torch.Generator().manual_seed(seed))
    state = person_biased(_randomise_norms(model.state_dict(), seed + 100))
    model.load_state_dict(state)
    variables = convert_d2_state({k: v.numpy() for k, v in state.items()})
    return model.eval(), variables


def _image(seed, size=IMG):
    return np.random.RandomState(seed).uniform(-120, 130, (size, size, 3)).astype(np.float32)


def _nchw(img):
    return torch.as_tensor(img).permute(2, 0, 1)[None]


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def kp():
    model, variables = _detector(TR.KeypointRCNN, 0)
    return model, variables, _image(0)


@pytest.fixture(scope="module")
def kp_feats(kp):
    model, _, image = kp
    with torch.no_grad():
        return model.backbone(_nchw(image))


# ------------------------------------------------------------------ ops --

@pytest.mark.parametrize("case", ["ties", "random_small", "random_multiblock", "invalid"])
def test_nms_matches_jax(case):
    rng = np.random.RandomState(3)
    if case == "ties":
        # Equal scores and duplicated boxes: the order is the stable one.
        base = np.asarray([[0, 0, 10, 10], [1, 1, 11, 11], [20, 20, 30, 30],
                           [0, 0, 10, 10]], np.float32)
        boxes = np.concatenate([base, base + 40, base]).astype(np.float32)
        scores = np.asarray([0.5] * 12, np.float32)
        block, n_out = 4, 8
    else:
        N = {"random_small": 40, "random_multiblock": 300, "invalid": 150}[case]
        xy = rng.uniform(0, 100, (N, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(5, 40, (N, 2))], 1).astype(np.float32)
        scores = rng.rand(N).astype(np.float32)
        scores[::9] = scores[1]
        if case == "invalid":
            scores[::4] = -np.inf
        block, n_out = (16, 60) if case != "random_small" else (128, 10)
    want, want_v = JO.nms_fixed(jnp.asarray(boxes), jnp.asarray(scores), 0.5, n_out, block=block)
    got, got_v = TO.nms_fixed(torch.as_tensor(boxes), torch.as_tensor(scores), 0.5, n_out,
                              block=block)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    # Batched: each image keeps its own selection.
    bb = torch.stack([torch.as_tensor(boxes), torch.as_tensor(boxes[::-1].copy())])
    bs = torch.stack([torch.as_tensor(scores), torch.as_tensor(scores[::-1].copy())])
    got_b, _ = TO.nms_fixed(bb, bs, 0.5, n_out, block=block)
    np.testing.assert_array_equal(got_b[0].numpy(), np.asarray(want))
    want_r, _ = JO.nms_fixed(jnp.asarray(boxes[::-1].copy()), jnp.asarray(scores[::-1].copy()),
                             0.5, n_out, block=block)
    np.testing.assert_array_equal(got_b[1].numpy(), np.asarray(want_r))


def test_box_coding_and_iou_match_jax():
    rng = np.random.RandomState(1)
    xy = rng.uniform(0, 50, (20, 2))
    a = np.concatenate([xy, xy + rng.uniform(2, 30, (20, 2))], 1).astype(np.float32)
    b = (a + rng.randn(20, 4).astype(np.float32)).astype(np.float32)
    d = rng.randn(20, 4).astype(np.float32) * 3
    for got, want in (
            (TO.pairwise_iou(torch.as_tensor(a), torch.as_tensor(b)), JO.pairwise_iou(a, b)),
            (TO.box_area(torch.as_tensor(a)), JO.box_area(a)),
            (TO.encode_boxes(torch.as_tensor(b), torch.as_tensor(a), (10., 10., 5., 5.)),
             JO.encode_boxes(b, a, (10., 10., 5., 5.))),
            (TO.decode_boxes(torch.as_tensor(d), torch.as_tensor(a)), JO.decode_boxes(d, a)),
            (TO.clip_boxes(torch.as_tensor(b) * 2, 40, 60), JO.clip_boxes(b * 2, 40, 60))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)


BOXES = np.asarray([[4.5, 7.25, 60.0, 50.5], [0.0, 0.0, 68.0, 52.0],
                    [30.2, 40.9, 33.7, 45.1], [20.0, 20.0, 20.1, 40.0],
                    [12.0, 3.0, 50.0, 9.5]], np.float32)


@pytest.mark.parametrize("sampling_ratio,aligned,mode", [
    (2, True, "border"), (1, True, "zeros"), (2, False, "border"), (0, True, "border"),
    (0, False, "border"), (1, True, "border")])
def test_roi_align_matches_jax(sampling_ratio, aligned, mode):
    f = np.random.RandomState(2).randn(13, 17, 8).astype(np.float32)
    want = JO.roi_align(jnp.asarray(f), jnp.asarray(BOXES), 0.25, 7,
                        sampling_ratio=sampling_ratio, aligned=aligned, mode=mode)
    got = TO.roi_align(torch.as_tensor(f)[None], torch.as_tensor(BOXES)[None], 0.25, 7,
                       sampling_ratio, aligned, mode)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_roi_align_legacy_off_map_follows_torchvision():
    """A legacy (aligned=False) box that leaves the map: the port follows
    torchvision's `bilinear_interpolate` (the twin's spec-level ROIAlign);
    the JAX single-level `roi_align` differs there (ROADMAP.md, section 3),
    while its multilevel pooler, the one the detectors run, agrees."""
    f = np.random.RandomState(2).randn(13, 17, 8).astype(np.float32)
    box = np.asarray([[-3.0, -2.0, 10.0, 70.0]], np.float32)
    got = TO.roi_align(torch.as_tensor(f)[None], torch.as_tensor(box)[None], 0.25, 7, 2,
                       False)[0]
    want = tv_roi_align(torch.as_tensor(f).permute(2, 0, 1)[None],
                        torch.cat([torch.zeros(1, 1), torch.as_tensor(box)], 1), 7, 0.25, 2,
                        aligned=False).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


@pytest.mark.parametrize("sampling_ratio,aligned", [(0, True), (0, False), (2, True), (2, False)])
def test_multilevel_roi_align_matches_jax(kp_feats, sampling_ratio, aligned):
    boxes = np.asarray([[4.5, 7.25, 60.0, 90.5], [0.0, 0.0, 127.0, 127.0],
                        [30.2, 40.9, 33.7, 55.1], [100.0, 90.0, 128.0, 128.0],
                        [0.0, 3.0, 120.0, 9.0], [50.0, 50.0, 50.5, 51.0]], np.float32)
    feats = [_nhwc(f) for f in kp_feats[:4]]
    want = JO.multilevel_roi_align([jnp.asarray(f[0]) for f in feats], jnp.asarray(boxes),
                                   (4, 8, 16, 32), 7, sampling_ratio=sampling_ratio,
                                   aligned=aligned)
    got = TO.multilevel_roi_align([torch.as_tensor(f) for f in feats],
                                  torch.as_tensor(boxes)[None], (4, 8, 16, 32), 7,
                                  sampling_ratio=sampling_ratio, aligned=aligned)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("size", [64, 104, 800])
def test_anchors_match_jax(size):
    feat = [(-(-size // s), -(-size // s)) for s in (4, 8, 16, 32)]
    feat.append((-(-feat[-1][0] // 2),) * 2)
    got = TA.fpn_anchors(size, feat_sizes=feat)
    want = JA.fpn_anchors(size, feat_sizes=feat)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if size == 800:
        assert got[4].shape[0] == 13 * 13 * 3


# ---------------------------------------------------------- backbone/FPN --

@pytest.mark.parametrize("size", [128, 104])
def test_backbone_fpn_matches_jax(kp, size):
    model, variables, _ = kp
    image = _image(1, size)
    bb = {"params": variables["params"]["trunk"]["backbone"],
          "batch_stats": variables["batch_stats"]["trunk"]["backbone"]}
    want = ResNet50FPN(depth=50).apply(bb, jnp.asarray(image)[None])
    with torch.no_grad():
        got = model.backbone(_nchw(image))
    expect = [-(-size // s) for s in (4, 8, 16, 32)]
    assert [g.shape[-1] for g in got] == expect + [-(-expect[-1] // 2)]
    for lvl, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        np.testing.assert_allclose(_nhwc(g), w, atol=2e-3 * np.abs(w).max(),
                                   err_msg=f"P{lvl + 2}")


# --------------------------------------------------------------- heads --

def test_rpn_head_and_proposals_match_jax(kp, kp_feats):
    model, variables, _ = kp
    feats_j = [jnp.asarray(_nhwc(f)[0]) for f in kp_feats]
    logits_j, deltas_j = JRPNHead().apply(
        {"params": variables["params"]["trunk"]["rpn_head"]}, feats_j)
    with torch.no_grad():
        logits_t, deltas_t = model.proposal_generator.rpn_head(kp_feats)
    for a, b in zip(logits_t + deltas_t, logits_j + deltas_j):
        np.testing.assert_allclose(_nhwc(a)[0], np.asarray(b), atol=1e-4, rtol=1e-4)
    # Proposal selection on the same head outputs.
    anchors = TA.fpn_anchors(IMG, feat_sizes=[f.shape[-2:] for f in kp_feats])
    props, scores, valid = TRPN.generate_proposals(logits_t, deltas_t, anchors, IMG,
                                                   post_nms_topk=TOPK)
    jprops, jscores, jvalid = j_proposals([jnp.asarray(_nhwc(x)[0]) for x in logits_t],
                                          [jnp.asarray(_nhwc(x)[0]) for x in deltas_t],
                                          anchors, IMG, post_nms_topk=TOPK)
    np.testing.assert_array_equal(valid[0].numpy(), np.asarray(jvalid))
    assert valid.sum() >= 8
    np.testing.assert_allclose(props[0].numpy(), np.asarray(jprops), atol=1e-4)
    np.testing.assert_allclose(scores[0].numpy(), np.asarray(jscores), atol=1e-6)


def test_box_head_and_inference_match_jax(kp, kp_feats):
    model, variables, _ = kp
    rng = np.random.RandomState(4)
    xy = rng.uniform(0, 90, (TOPK, 2))
    props = np.concatenate([xy, xy + rng.uniform(8, 60, (TOPK, 2))], 1).astype(np.float32)
    nhwc = [torch.as_tensor(_nhwc(f)) for f in kp_feats[:4]]
    roi = TH.pooled_box_features(nhwc, torch.as_tensor(props)[None], 7)
    want_roi = JH.pooled_box_features([jnp.asarray(f[0].numpy()) for f in nhwc],
                                      jnp.asarray(props), 7)
    np.testing.assert_allclose(_nhwc(roi), np.asarray(want_roi), rtol=1e-4,
                               atol=1e-6 * np.abs(np.asarray(want_roi)).max())
    with torch.no_grad():
        cls, deltas = model.roi_heads.box_predictor(model.roi_heads.box_head(roi))
    jcls, jdeltas = JH.BoxHead(num_classes=1).apply(
        {"params": variables["params"]["trunk"]["box_head"]}, jnp.asarray(_nhwc(roi)))
    np.testing.assert_allclose(cls.numpy(), np.asarray(jcls), atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(deltas.numpy(), np.asarray(jdeltas), atol=5e-4, rtol=1e-3)
    valid = np.ones(TOPK, bool)
    valid[::5] = False
    probs = torch.softmax(cls, -1)[:, 0].numpy()
    assert np.abs(probs[valid] - 0.05).min() > MARGIN
    got = TH.box_inference(cls[None], deltas[None], torch.as_tensor(props)[None],
                           torch.as_tensor(valid)[None], IMG, max_detections=DETS)
    want = JH.box_inference(jnp.asarray(cls.numpy()), jnp.asarray(deltas.numpy()),
                            jnp.asarray(props), jnp.asarray(valid), IMG, max_detections=DETS)
    np.testing.assert_array_equal(got[2][0].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0][0].numpy(), np.asarray(want[0]), atol=1e-4)
    np.testing.assert_allclose(got[1][0].numpy(), np.asarray(want[1]), atol=1e-6)


def test_keypoint_head_and_decode_match_jax(kp, kp_feats):
    model, variables, _ = kp
    boxes = np.asarray([[4.5, 7.25, 60.0, 90.5], [0.0, 0.0, 127.0, 127.0],
                        [30.2, 40.9, 33.7, 55.1], [60.0, 60.0, 61.5, 61.5]], np.float32)
    nhwc = [torch.as_tensor(_nhwc(f)) for f in kp_feats[:4]]
    roi = TH.pooled_box_features(nhwc, torch.as_tensor(boxes)[None], 14)
    with torch.no_grad():
        heat = model.roi_heads.keypoint_head(roi)
    jheat = JH.KeypointHead().apply({"params": variables["params"]["keypoint_head"]},
                                    jnp.asarray(_nhwc(roi)))
    np.testing.assert_allclose(_nhwc(heat), np.asarray(jheat), atol=5e-4, rtol=1e-3)
    # detectron2's decode on the same heatmaps and boxes (random heatmaps,
    # boxes tiny to full-frame, fractional corners).
    rng = np.random.RandomState(42)
    hm = rng.randn(7, 17, 56, 56).astype(np.float32)
    dboxes = np.asarray([[10.0, 20.0, 150.0, 140.0], [30.5, 40.25, 90.75, 100.5],
                         [5.0, 5.0, 25.0, 60.0], [0.0, 0.0, 160.0, 160.0],
                         [100.0, 90.0, 103.0, 93.5], [0.0, 10.0, 1.0, 11.0],
                         [150.0, 0.0, 160.0, 155.0]], np.float32)
    xy, sc = TH.keypoint_decode(torch.as_tensor(hm), torch.as_tensor(dboxes), 160)
    jxy, jsc = JH.keypoint_decode(jnp.asarray(hm.transpose(0, 2, 3, 1)), jnp.asarray(dboxes),
                                  grid_size=160)
    np.testing.assert_allclose(xy.numpy(), np.asarray(jxy), atol=2e-3, rtol=1e-5)
    np.testing.assert_allclose(sc.numpy(), np.asarray(jsc), atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def pr():
    model, variables = _detector(TR.PointRendRCNN, 3)
    return model, variables, _image(5)


def test_pointrend_coarse_subdivision_and_paste_match_jax(pr):
    model, variables, image = pr
    with torch.no_grad():
        feats = model.backbone(_nchw(image))
    p2 = torch.as_tensor(_nhwc(feats[0]))
    boxes = np.asarray([[10.3, 20.7, 90.1, 120.4], [50.0, 5.5, 80.0, 60.0]], np.float32)
    roi = TO.roi_align(p2, torch.as_tensor(boxes)[None], 0.25, 14, 1, mode="zeros")[0]
    jroi = JO.roi_align(jnp.asarray(p2[0].numpy()), jnp.asarray(boxes), 0.25, 14,
                        sampling_ratio=1, mode="zeros")
    np.testing.assert_allclose(roi.numpy(), np.asarray(jroi), rtol=1e-4,
                               atol=1e-6 * np.abs(np.asarray(jroi)).max())
    with torch.no_grad():
        coarse = model.roi_heads.mask_coarse_head(roi.permute(0, 3, 1, 2))
    jcoarse = JPR.CoarseMaskHead(num_classes=80).apply(
        {"params": variables["params"]["coarse_head"]}, jroi)
    np.testing.assert_allclose(_nhwc(coarse), np.asarray(jcoarse), atol=5e-4, rtol=1e-3)

    with torch.no_grad():
        refined = TPR.subdivision_inference(model.roi_heads.mask_point_head, coarse, p2,
                                            torch.as_tensor(boxes), torch.zeros(2, dtype=torch.int64))
    head = JPR.PointHead(num_classes=80)
    ph = {"params": variables["params"]["point_head"]}
    jrefined = JPR.subdivision_inference(lambda f, c: head.apply(ph, f, c),
                                         jnp.asarray(_nhwc(coarse)), jnp.asarray(p2[0].numpy()),
                                         jnp.asarray(boxes), channel=0)
    rj = np.asarray(jrefined)[..., 0]
    rt = refined[:, 0].numpy()
    assert rt.shape == (2, 224, 224)
    assert np.isclose(rt, rj, atol=5e-3, rtol=1e-2).mean() > 0.995
    # Pasting the same refined logits.
    got = TPR.paste_mask(torch.as_tensor(rj.copy()), torch.as_tensor(boxes), IMG, IMG).numpy()
    want = np.asarray(jax.vmap(lambda m, b: JPR.paste_mask(m, b, IMG, IMG))(
        jnp.asarray(rj), jnp.asarray(boxes)))
    assert got.dtype == bool and got.mean() > 0.1
    assert (got == want.astype(bool)).mean() > 0.998


# ------------------------------------------------------ whole detectors --

@pytest.mark.parametrize("kind", ["keypoint", "pointrend"])
def test_whole_detector_matches_jax(kp, pr, monkeypatch, kind):
    model, variables, image = kp if kind == "keypoint" else pr
    out = _check_margins(monkeypatch, model, _nchw(image))
    jmodel = (JKeypointRCNN if kind == "keypoint" else JPointRendRCNN)(
        post_nms_topk=TOPK, max_detections=DETS)
    want = jmodel.apply(variables, jnp.asarray(image))
    valid = out["valid"][0].numpy()
    np.testing.assert_array_equal(valid, np.asarray(want["valid"]))
    assert valid.any()
    np.testing.assert_allclose(out["boxes"][0].numpy()[valid], np.asarray(want["boxes"])[valid],
                               atol=0.1)
    np.testing.assert_allclose(out["scores"][0].numpy(), np.asarray(want["scores"]), atol=5e-4,
                               rtol=1e-3)
    if kind == "keypoint":
        # The keypoints move with their boxes (0.1 px); heatmap values differ
        # at ~1e-4 between the stacks, which can move an argmax between
        # near-tied cells, so a few may move further.
        d = np.abs(out["keypoints"][0].numpy() - np.asarray(want["keypoints"]))[valid]
        assert (d.max(-1) < 0.1).mean() > 0.9 and d.max() < 8.0
    else:
        m = out["masks"][0].numpy()[valid]
        assert m.mean() > 0.02
        assert (m == np.asarray(want["masks"])[valid]).mean() > 0.99


def test_bfloat16_backbone_runs_close(kp):
    model, _, image = kp
    state = model.state_dict()
    with torch.device("meta"):
        bf = TR.KeypointRCNN(post_nms_topk=TOPK, max_detections=DETS, backbone_dtype="bfloat16")
    load_detector_state(bf, state)
    with torch.no_grad():
        f32 = model.backbone(_nchw(image))
        with torch.autocast("cpu", dtype=torch.bfloat16):
            b16 = bf.backbone(_nchw(image))
        out = bf(_nchw(image))
    for a, b in zip(f32, b16):
        assert b.dtype == torch.float32
        assert (a - b).abs().max() < 0.1 * a.abs().max()
    assert torch.isfinite(out["keypoints"]).all() and out["valid"].any()


# ------------------------------------------------------------- weights --

_KINDS = {"keypoint": (JKeypointRCNN, TR.KeypointRCNN), "pointrend": (JPointRendRCNN, TR.PointRendRCNN),
          "densepose": (JDensePoseRCNN, TR.DensePoseRCNN)}


@pytest.mark.parametrize("kind", ["keypoint", "pointrend", "densepose"])
def test_flax_weights_round_trip_through_d2_pickle(tmp_path, kind):
    """flax variables -> `flax_detector_to_torch_state_dict` -> a
    detectron2 pickle -> the JAX `load_d2_pkl`: the variables come back
    exactly; the pickle loads into the port by name, strict (DensePose:
    the R101 trunk, the V1ConvX head and the four deconvolution branches)."""
    jmodel = _KINDS[kind][0](post_nms_topk=TOPK, max_detections=DETS)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((64, 64, 3)))
    rng = np.random.RandomState(0)
    variables = jax.tree_util.tree_map(
        lambda v: rng.randn(*v.shape).astype(np.float32), shapes)
    state = flax_detector_to_torch_state_dict(variables)
    path = str(tmp_path / "d2.pkl")
    save_d2_pkl(path, {k: torch.as_tensor(v) for k, v in state.items()})
    back = jax_load_d2_pkl(path)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(variables))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(flat_got) == set(flat_want)
    for k, v in flat_want.items():
        np.testing.assert_array_equal(np.asarray(flat_got[k]), v, err_msg=str(k))
    with torch.device("meta"):
        model = _KINDS[kind][1]()
    load_detector_state(model, load_d2_pkl(path))
    assert not any(t.is_meta for t in model.state_dict().values())
    # Extra detectron2 entries are ignored; a missing one is named.
    with open(path, "rb") as f:
        ckpt = pickle.load(f)
    del ckpt["model"]["backbone.fpn_output3.bias"]
    ckpt["model"]["pixel_mean"] = np.zeros(3, np.float32)
    with open(path, "wb") as f:
        pickle.dump(ckpt, f)
    with torch.device("meta"):
        model = _KINDS[kind][1]()
    with pytest.raises(KeyError, match="fpn_output3.bias"):
        load_detector_state(model, load_d2_pkl(path))


def test_deeplab_head_scopes_are_named():
    """A DeepLab DensePose head's flax scopes (ASPP, NonLocal, the stacked
    convs' GroupNorms) get detectron2's names, none dropped."""
    k = np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)
    variables = {"params": {"densepose_head": {
        "aspp": {"conv1x1": {"kernel": k}, "gn_pool": {"scale": np.ones(4, np.float32)}},
        "nonlocal": {"phi": {"kernel": k, "bias": np.zeros(4, np.float32)}},
        "gn3": {"scale": np.ones(4, np.float32), "bias": np.zeros(4, np.float32)}}}}
    out = flax_detector_to_torch_state_dict(variables)
    p = "roi_heads.densepose_head."
    assert sorted(out) == sorted(p + n for n in (
        "ASPP.convs.0.0.weight", "ASPP.convs.4.2.weight", "NLBlock.phi.0.weight",
        "NLBlock.phi.0.bias", "body_conv_fcn3.norm.weight", "body_conv_fcn3.norm.bias"))
    np.testing.assert_array_equal(out[p + "ASPP.convs.0.0.weight"], k.transpose(3, 2, 0, 1))


def test_normalisation_matches_jax():
    """detectron2's input: RGB uint8 -> BGR minus the pixel mean, on the
    host (HWC) and on the device (NCHW, from a uint8 batch)."""
    from straps_tpu.perception.rcnn import normalise_image as j_normalise

    img = np.random.RandomState(6).randint(0, 256, (2, 9, 7, 3)).astype(np.uint8)
    want = np.stack([j_normalise(i) for i in img])
    np.testing.assert_array_equal(TR.normalise_image(img[0]), want[0])
    got = TR.normalise_image_device(torch.as_tensor(img))
    assert got.shape == (2, 3, 9, 7) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
