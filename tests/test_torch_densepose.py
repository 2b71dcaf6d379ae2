"""DensePose-RCNN of the PyTorch port (`straps_tpu_torch/perception/
densepose.py`, `rcnn.DensePoseRCNN`) against the JAX package's, on the same
numpy inputs and the same weights: the JAX model's variables (seeded
numpy, FrozenBN statistics away from the identity, the person logit and
the coarse segmentation's foreground raised) go to the port through
`flax_detector_to_torch_state_dict`.

Tolerances: the head and predictor on the same pooled features 1e-4 of
each output's largest value; `densepose_to_iuv` exact; the legacy ratio-2
pooler against the JAX multilevel pooler (the one that follows torchvision,
ROADMAP.md section 3) 1e-5 on unit-variance maps; the R101 trunk 2e-3 of
each level's largest value, as `tests/test_torch_perception.py` holds the
R50 one.  Part labels are argmaxes of resampled logits: a label may differ
only where the deciding scores' top two lie within twice the two stacks'
largest logit difference (`argmax_near_ties`), on under 0.1% of the pixels,
the JAX suite's own rule for its paste (`tests/test_perception_parity.py:
478-486`).  Whole detectors: boxes within 1e-3 px, after the seed's NMS,
score and top-k decisions are shown to clear their thresholds by 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from straps_tpu.perception import DensePoseRCNN as JDensePoseRCNN
from straps_tpu.perception import densepose as JD
from straps_tpu.perception.fpn import ResNet50FPN
from straps_tpu.perception.ops import multilevel_roi_align as j_multilevel_roi_align
from straps_tpu_torch.perception import densepose as TD
from straps_tpu_torch.perception import heads as TH
from straps_tpu_torch.perception import rcnn as TR
from straps_tpu_torch.perception.convert_d2 import (
    flax_detector_to_torch_state_dict, load_detector_state,
)
from torch_margins import _check_margins, argmax_near_ties
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

IMG, TOPK, DETS = 128, 64, 4


# detectron2's initial standard deviations of the prediction layers, but
# the RPN's box deltas 100x smaller: on these random features (values in
# the hundreds) detectron2's 0.01 gives deltas of tens of anchor sizes,
# whose float error alone moves a proposal by 4e-3 px; trained deltas are
# of order 1.
_PREDICTION_STD = {"anchor_deltas": 1e-4, "rpn_head": 0.01, "cls_score": 0.01,
                   "bbox_pred": 0.001}


def flax_densepose_variables(depth, seed, size=IMG):
    """Seeded numpy variables of the JAX `DensePoseRCNN`: the prediction
    layers' weights at detectron2's initial scale, other weights normal with
    variance 1/fan_in, biases 0, FrozenBN affines and statistics drawn
    around the identity; the person logit raised by 4 and the coarse
    segmentation's foreground channels by 1.5, so that the random detector
    finds people whose boxes are mostly foreground."""
    jmodel = JDensePoseRCNN(post_nms_topk=TOPK, max_detections=DETS, backbone_depth=depth,
                            output_part_maps=True)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((size, size, 3)))
    rng = np.random.RandomState(seed)

    def fill(path, v):
        keys = [getattr(k, "key", None) for k in path]
        leaf, scope = keys[-1], keys[-2]
        norm = "bn" in scope
        if v.ndim >= 2:
            std = next((s for k, s in _PREDICTION_STD.items() if k in keys),
                       np.prod(v.shape[:-1]) ** -0.5)
            out = rng.randn(*v.shape) * std
        elif leaf == "scale":
            out = rng.uniform(0.7, 1.3, v.shape)
        elif leaf == "var":
            out = rng.uniform(0.7, 1.4, v.shape)
        elif leaf == "mean":
            out = rng.uniform(-0.3, 0.3, v.shape)
        else:
            out = rng.uniform(-0.2, 0.2, v.shape) if norm else np.zeros(v.shape)
        return np.asarray(out, np.float32)

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    variables["params"]["trunk"]["box_head"]["cls_score"]["bias"][0] += 4.0
    variables["params"]["densepose_predictor"]["ann_index_lowres"]["bias"][1:] += 1.5
    return jmodel, variables


def port_model(variables, depth):
    with torch.device("meta"):
        model = TR.DensePoseRCNN(post_nms_topk=TOPK, max_detections=DETS, backbone_depth=depth,
                                 output_part_maps=True)
    state = {k: torch.as_tensor(v) for k, v in
             flax_detector_to_torch_state_dict(variables).items()}
    return load_detector_state(model, state)


_BUILT = {}
# Per depth, a seed whose random detector finds DETS people (at depth 101
# seed 101 finds none).
SEEDS = {50: 50, 101: 100}


def _dp(depth):
    """(JAX model, variables, port model, image) at `depth`, built once per
    module."""
    if depth not in _BUILT:
        seed = SEEDS[depth]
        jmodel, variables = flax_densepose_variables(depth, seed)
        image = np.random.RandomState(seed + 1).uniform(-120, 130, (IMG, IMG, 3)).astype(
            np.float32)
        _BUILT[depth] = jmodel, variables, port_model(variables, depth), image
    return _BUILT[depth]


@pytest.fixture(scope="module", autouse=True)
def _release_models():
    yield
    _BUILT.clear()


def _nchw(img):
    return torch.as_tensor(img).permute(2, 0, 1)[None]


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


# ------------------------------------------------------- head + labels --

def test_head_and_predictor_match_jax():
    """V1ConvX head and the four branches on the same pooled features; the
    2x bilinear upsampling (torch clamps the source index at the border,
    `jax.image.resize` renormalises its taps) gives the same edge rows."""
    _, variables, model, _ = _dp(50)
    roi = np.random.RandomState(3).randn(3, 14, 14, 256).astype(np.float32)
    with torch.no_grad():
        x = model.roi_heads.densepose_head(torch.as_tensor(roi).permute(0, 3, 1, 2))
        got = model.roi_heads.densepose_predictor(x)
        low = model.roi_heads.densepose_predictor.index_uv_lowres(x)
    jx = JD.DensePoseHead().apply({"params": variables["params"]["densepose_head"]},
                                  jnp.asarray(roi))
    np.testing.assert_allclose(_nhwc(x), np.asarray(jx), atol=1e-4 * np.abs(jx).max())
    want = JD.DensePosePredictor().apply({"params": variables["params"]["densepose_predictor"]},
                                         jnp.asarray(_nhwc(x)))
    for name, g, w in zip("SIUV", got, want):
        w = np.asarray(w)
        assert g.shape[-2:] == (56, 56)
        np.testing.assert_allclose(_nhwc(g), w, atol=1e-4 * np.abs(w).max(), err_msg=name)
    up = F.interpolate(low, scale_factor=2, mode="bilinear", align_corners=False)
    jup = np.asarray(jax.image.resize(jnp.asarray(_nhwc(low)), (3, 56, 56, 25), "bilinear"))
    for rows in (np.s_[:, :2], np.s_[:, -2:], np.s_[:, :, :2], np.s_[:, :, -2:]):
        np.testing.assert_allclose(_nhwc(up)[rows], jup[rows], atol=1e-6)
    np.testing.assert_allclose(_nhwc(up), jup, atol=1e-6)


def test_densepose_to_iuv_is_exact():
    rng = np.random.RandomState(4)
    s = rng.randn(3, 15, 56, 56).astype(np.float32)
    i, u, v = (rng.randn(3, 25, 56, 56).astype(np.float32) for _ in range(3))
    s[0, :, :4] = 0.0                      # ties: the first maximum wins on both sides
    i[1, :, :, :4] = 1.0
    got = TD.densepose_to_iuv(*(torch.as_tensor(a) for a in (s, i, u, v)))
    want = JD.densepose_to_iuv(*(jnp.asarray(a.transpose(0, 2, 3, 1)) for a in (s, i, u, v)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0] == 0).float().mean() < 0.5


PASTE_BOXES = np.asarray([
    [17.3, 9.8, 93.6, 121.2],    # generic fractional box
    [0.0, 0.0, 128.0, 128.0],    # full frame
    [40.3, 55.0, 128.0, 127.5],  # flush to the right edge
    [60.0, 60.0, 60.4, 83.0],    # sub-pixel width -> max(int(w), 1)
    [20.0, 30.0, 45.0, 38.0],    # downscale on y (box h < 56)
], np.float32)


def _resized_scores(s, i, box):
    """The S and I logits resized to `box`'s integer size, as the paste
    does (detectron2's resize-then-argmax)."""
    w = max(int(box[2] - box[0]), 1)
    h = max(int(box[3] - box[1]), 1)
    return [F.interpolate(torch.as_tensor(a)[None], (h, w), mode="bilinear",
                          align_corners=False)[0] for a in (s, i)]


def _label_mismatch_at_ties(got, want, s, i, boxes, margin):
    """Frame labels `got` vs `want` (R, H, W): every differing pixel lies
    inside its box where the resized S or I scores are within `margin` of
    a tie; returns the share of differing pixels."""
    for r, box in enumerate(boxes):
        diff = np.argwhere(got[r] != want[r])
        if not len(diff):
            continue
        s_b, i_b = _resized_scores(s[r], i[r], box)
        ties = argmax_near_ties(s_b, margin) | argmax_near_ties(i_b, margin)
        y0, x0 = int(box[1]), int(box[0])
        assert all(0 <= y - y0 < ties.shape[0] and 0 <= x - x0 < ties.shape[1]
                   and bool(ties[y - y0, x - x0]) for y, x in diff), (r, box)
    return float((got != want).mean())


def test_paste_matches_jax():
    """detectron2's paste (resize to the integer box, argmax after the
    resize, paste at the truncated origin) against the JAX static-grid
    paste on the same logits: labels differ only at float ties of the
    resampled scores."""
    rng = np.random.RandomState(11)
    R = len(PASTE_BOXES)
    s = rng.randn(R, 15, 56, 56).astype(np.float32)
    i = rng.randn(R, 25, 56, 56).astype(np.float32)
    got = TD.paste_part_labels(torch.as_tensor(s), torch.as_tensor(i),
                               torch.as_tensor(PASTE_BOXES), IMG, IMG).numpy()
    want = np.asarray(jax.vmap(lambda a, b, box: JD.paste_densepose_labels(a, b, box, IMG, IMG))(
        jnp.asarray(s.transpose(0, 2, 3, 1)), jnp.asarray(i.transpose(0, 2, 3, 1)),
        jnp.asarray(PASTE_BOXES)))
    assert got.dtype == np.uint8 and got.shape == (R, IMG, IMG)
    assert _label_mismatch_at_ties(got, want, s, i, PASTE_BOXES, 1e-4) < 1e-3
    for r, box in enumerate(PASTE_BOXES):
        x0, y0 = int(box[0]), int(box[1])
        w, h = max(int(box[2] - box[0]), 1), max(int(box[3] - box[1]), 1)
        outside = np.ones((IMG, IMG), bool)
        outside[y0:y0 + h, x0:x0 + w] = False
        assert not got[r][outside].any() and got[r][~outside].any()


def test_legacy_ratio2_pooler_matches_jax_multilevel():
    """DensePose's box and ROI pooler (legacy ROIAlign, sampling ratio 2,
    roi sides clamped to 1 px) against the JAX multilevel pooler; the third
    box is narrower than one pixel of its level."""
    rng = np.random.RandomState(5)
    feats = [rng.randn(1, IMG // s, IMG // s, 8).astype(np.float32) for s in (4, 8, 16, 32)]
    boxes = np.asarray([[4.5, 7.25, 60.0, 90.5], [10.0, 20.0, 120.0, 126.0],
                        [30.0, 40.0, 33.0, 43.5], [0.0, 0.0, 128.0, 128.0],
                        [100.0, 2.0, 128.0, 9.0]], np.float32)
    got = TH.pooled_box_features([torch.as_tensor(f) for f in feats], torch.as_tensor(boxes)[None],
                                 14, aligned=False, sampling_ratio=2)
    want = j_multilevel_roi_align([jnp.asarray(f[0]) for f in feats], jnp.asarray(boxes),
                                  (4, 8, 16, 32), 14, sampling_ratio=2, aligned=False)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5)


def test_r101_trunk_matches_jax():
    _, variables, model, image = _dp(101)
    bb = {"params": variables["params"]["trunk"]["backbone"],
          "batch_stats": variables["batch_stats"]["trunk"]["backbone"]}
    want = ResNet50FPN(depth=101).apply(bb, jnp.asarray(image)[None])
    with torch.no_grad():
        got = model.backbone(_nchw(image))
    assert len(model.backbone.bottom_up.res4) == 23
    for lvl, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        np.testing.assert_allclose(_nhwc(g), w, atol=2e-3 * np.abs(w).max(), err_msg=f"P{lvl + 2}")


# ------------------------------------------------------ whole detector --

@pytest.mark.parametrize("depth", [50, 101])
def test_whole_densepose_rcnn_matches_jax(monkeypatch, depth):
    jmodel, variables, model, image = _dp(depth)
    logits = []
    model.roi_heads.densepose_predictor.register_forward_hook(
        lambda m, i, o: logits.append([t.detach() for t in o]))
    out = _check_margins(monkeypatch, model, _nchw(image))
    s, i = logits[-1][:2]
    want, inter = jax.jit(lambda v, x: jmodel.apply(v, x, capture_intermediates=True,
                                                    mutable=["intermediates"]))(
        variables, jnp.asarray(image))
    js, ji = (np.asarray(t) for t in inter["intermediates"]["densepose_predictor"]["__call__"][0][:2])
    valid = out["valid"][0].numpy()
    np.testing.assert_array_equal(valid, np.asarray(want["valid"]))
    assert valid.all()
    boxes = out["boxes"][0].numpy()
    np.testing.assert_allclose(boxes, np.asarray(want["boxes"]), atol=1e-3)
    np.testing.assert_allclose(out["scores"][0].numpy(), np.asarray(want["scores"]), atol=5e-4,
                               rtol=1e-3)
    # Twice the largest logit difference: an argmax can differ only where
    # the top two scores lie within it.
    margin = 2 * max(float(np.abs(_nhwc(s) - js).max()), float(np.abs(_nhwc(i) - ji).max()))
    assert margin < 1e-3 * np.abs(ji).max()
    part = out["part_index"][0].numpy()
    jpart = np.asarray(want["part_index"])
    ties = (argmax_near_ties(s, margin, dim=1) | argmax_near_ties(i, margin, dim=1)).numpy()
    assert (part == jpart)[~ties].all() and (part != jpart).mean() < 1e-3
    for key in ("part_map", "masks"):
        got = out[key][0].numpy()
        ref = np.asarray(want[key])
        ref = ref if key == "masks" else ref.astype(np.uint8)
        share = _label_mismatch_at_ties(got.astype(np.uint8), ref.astype(np.uint8), s.numpy(),
                                        i.numpy(), boxes, margin)
        assert share < 1e-3, (key, share)
    # The boxes are mostly foreground (a box flat on the frame's last row
    # pastes outside it).
    inside = [out["masks"][0, r, int(b[1]):int(b[1]) + max(int(b[3] - b[1]), 1),
                           int(b[0]):int(b[0]) + max(int(b[2] - b[0]), 1)] for r, b in enumerate(boxes)]
    assert all(m.float().mean() > 0.5 for m in inside if m.numel()) and inside[0].numel()
    # U and V of the parts both sides chose.
    same = part == jpart
    for key in ("u", "v"):
        w = np.asarray(want[key])
        np.testing.assert_allclose(out[key][0].numpy()[same], w[same],
                                   atol=1e-3 * np.abs(w).max())


def test_bfloat16_backbone_runs_close():
    """The bfloat16 backbone pools both ROI sets (ratio 2) in bfloat16 and
    returns the float32 heads' outputs."""
    _, _, model, image = _dp(50)
    with torch.device("meta"):
        bf = TR.DensePoseRCNN(post_nms_topk=TOPK, max_detections=DETS, backbone_depth=50,
                              backbone_dtype="bfloat16")
    load_detector_state(bf, model.state_dict())
    with torch.no_grad():
        out = bf(_nchw(image))
        ref = model(_nchw(image))
    assert out["valid"].any() and out["u"].dtype == torch.float32
    assert torch.isfinite(out["u"]).all() and out["masks"].any()
    assert (out["boxes"] - ref["boxes"]).abs().max() < 2.0
