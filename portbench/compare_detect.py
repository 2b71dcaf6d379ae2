"""The numbers that decide `correct` in the photo path's cells: the
selected silhouettes and joints that the timed path wrote under
`<out>/proxies`, and every call's returned predictions, against the
reference from the same photos and pickles.

With seeded weights the class scores are unrelated to the proposals'
objectness, so any of the 512 post-NMS proposals may become a detection,
and a proposal at the top-k cut or at an NMS IoU within float32's reach of
0.7 decides an image's detections either way on the two sides: one image
of 32 in one call of 14 (PERF.md §2).  Such an image changes wholly.  So
the silhouettes and joints are judged image by image, by the share of
images (and of joints) that part from the reference, and the regressor's
outputs on the images whose proxies agree.
"""

import numpy as np

from portbench import compare

KEYS = ("verts", "shape", "pose_rotmats", "cam_wp")
FAR_PX = 0.5
# Silhouette pixels an image may differ in and still agree: float32 order
# flips pixels at the paste's 0.5 threshold, at most 3 an image over the
# calibration's seeds.
SIL_PX = 8


def image_gaps(prog: dict, ref: dict, key: str) -> np.ndarray:
    """Each image's largest difference of `key` over calls (NaN where the
    shapes differ)."""
    (r,) = ref["calls"]
    r = np.asarray(r[key], np.float64)
    out = np.zeros(len(r))
    for c in prog["calls"]:
        c = np.asarray(c[key], np.float64)
        if c.shape != r.shape:
            return np.full(len(r), np.nan)
        out = np.maximum(out, np.abs(c - r).reshape(len(r), -1).max(axis=1))
    return out


def detect_numbers(prog: dict, ref: dict) -> dict:
    """`prog` and `ref` hold `sils` (N, 512, 512), `joints` (N, 17, 2) and
    `calls`, a list of {key: array} predictions (the reference's one).

    - `sil_images_off`: the share of images whose silhouette differs in
      more than `SIL_PX` pixels;
    - `sil_mismatch`: the share of silhouette pixels that differ;
    - `joints_far_share`: the share of joints more than 0.5 px away (512
      frame);
    - `joints_gap_px`: the median joint's distance;
    - `verts_gap_m`, `cam_gap`, `params_gap`: the largest difference of
      the vertices (m), cameras, and shapes and rotations, over calls and
      over the images whose silhouette and joints agree; MISSING where
      fewer than half of them do."""
    n = len(ref["sils"])
    if np.shape(prog["sils"]) != np.shape(ref["sils"]) or \
            np.shape(prog["joints"]) != np.shape(ref["joints"]):
        return {k: compare.MISSING for k in ("sil_images_off", "sil_mismatch",
                                             "joints_far_share", "joints_gap_px", "verts_gap_m",
                                             "cam_gap", "params_gap")}
    diff = (np.asarray(prog["sils"]) != np.asarray(ref["sils"])).reshape(n, -1).sum(axis=1)
    d = np.linalg.norm(np.asarray(prog["joints"], np.float64)
                       - np.asarray(ref["joints"], np.float64), axis=-1)
    agree = (diff <= SIL_PX) & (d <= FAR_PX).all(axis=1)
    out = {"sil_images_off": float(np.mean(diff > SIL_PX)),
           "sil_mismatch": float(diff.sum() / np.asarray(ref["sils"]).size),
           "joints_far_share": float(np.mean(d > FAR_PX)),
           "joints_gap_px": float(np.median(d))}
    (r,) = ref["calls"]
    if agree.sum() * 2 < n:
        return {**out, "verts_gap_m": compare.MISSING, "cam_gap": compare.MISSING,
                "params_gap": compare.MISSING}

    def gap(key):
        return max(compare._gap(np.asarray(c[key])[agree], np.asarray(r[key])[agree])
                   for c in prog["calls"])
    out["verts_gap_m"] = gap("verts")
    out["cam_gap"] = gap("cam_wp")
    out["params_gap"] = max(gap("shape"), gap("pose_rotmats"))
    return out
