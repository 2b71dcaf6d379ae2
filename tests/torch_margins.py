"""Decision margins of the port's detectors, for tests that run a whole
detector: no decision that shapes its outputs (an NMS IoU, a score
threshold, a top-k cut) may lie within `MARGIN` of its threshold, where
two stacks' rounding could decide it either way.

Imports neither JAX nor the JAX package, so that the card's tests
(`tests/test_torch_cuda.py`) use it too.
"""

import torch

from straps_tpu_torch.perception import ops as TO
from straps_tpu_torch.perception import rpn as TRPN

MARGIN = 1e-4


def record_nms(monkeypatch):
    """Record the inputs and outputs of every `nms_fixed` call the port
    makes from now on."""
    calls = []
    real = TO.nms_fixed

    def nms(boxes, scores, thr, n, **kw):
        idx, valid = real(boxes, scores, thr, n, **kw)
        calls.append((boxes, scores, thr, n, idx, valid))
        return idx, valid
    monkeypatch.setattr(TO, "nms_fixed", nms)
    return calls


def assert_nms_margins(calls, margin=MARGIN):
    """No NMS decision that shapes an output lies within `margin` of its
    IoU threshold.  An IoU near the threshold between a kept box and a later
    candidate is harmless only where the candidate was not kept, and either
    another kept box suppresses it by more than the margin or it comes
    after the last output.  (Random detectors propose boxes near their
    anchors, and anchor pairs sit at fixed IoUs such as 0.698, so such
    pairs exist at every seed.)"""
    for boxes, scores, thr, n, idx, valid in calls:
        for b in range(boxes.shape[0]):
            kept = idx[b][valid[b]]
            pos = torch.empty(scores.shape[1], dtype=torch.int64)
            pos[torch.sort(-scores[b], stable=True).indices] = torch.arange(scores.shape[1])
            live = torch.isfinite(scores[b]).nonzero().flatten()
            iou = TO.pairwise_iou(boxes[b][kept], boxes[b][live])
            later = pos[live][None, :] > pos[kept][:, None]
            near = ((iou - thr).abs() <= margin) & later
            firm = ((iou > thr + margin) & later).any(0)
            last = pos[kept].max() if len(kept) == n else scores.shape[1]
            for _, j in near.nonzero().tolist():
                assert not bool(torch.isin(live[j], kept)), ("a kept box at the threshold", thr)
                assert firm[j] or pos[live[j]] > last, ("a decision at the threshold", thr)


def argmax_near_ties(scores, margin, dim=0):
    """Where the top two values along `dim` lie within `margin`: the
    pixels whose argmax (DensePose's coarse segmentation and part index)
    two stacks that differ by less than `margin / 2` may decide either
    way.  Every other argmax must agree."""
    top2 = torch.topk(torch.as_tensor(scores), 2, dim=dim).values
    return (top2.select(dim, 0) - top2.select(dim, 1)) <= margin


def _check_margins(monkeypatch, model, images):
    """Run the port's detector (on the CPU) and show that no decision that
    shapes its outputs lies within MARGIN of its threshold: the NMS IoUs
    (`assert_nms_margins`), the box-NMS candidates' scores against the
    score threshold, the per-level top-k cuts."""
    calls, topk = record_nms(monkeypatch), []
    real_topk = TRPN.top_k_stable

    def top_k(values, k):
        topk.append((values, k))
        return real_topk(values, k)
    monkeypatch.setattr(TRPN, "top_k_stable", top_k)
    with torch.no_grad():
        out = model(images)
    assert_nms_margins(calls)
    for boxes, scores, thr, n, idx, valid in calls:
        if thr == 0.5:       # the box NMS: its candidates passed the score threshold
            live = torch.isfinite(scores)
            assert ((scores[live] - model.score_thresh) > MARGIN).all()
    for values, k in topk:
        if values.shape[-1] > k:
            s = torch.sort(values, dim=-1, descending=True).values
            assert (s[..., k - 1] - s[..., k]).min() > MARGIN, "top-k cut"
    return out
