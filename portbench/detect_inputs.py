"""The photo path's inputs, made from the run's seed: seeded detectron2
pickles of Keypoint R-CNN and PointRend R50-FPN that find people, and
photos of seeded bodies.  Both sides read the same files.

The weights follow `chip_smoke.py`'s recipe with one change.  The recipe: the port's
seeded detectron2 initialisation (`rcnn.init_random_weights`), PointRend's
person class raised by 6, the person masks' coarse and point predictions
by 1.5, the RPN's box-delta weights scaled by 0.1 so that proposals move
by deltas of order 1, as trained ones do.  The change: both box
predictors' class-score weights are scaled by 0.1.  The random features
reach magnitudes of ~70, so detectron2's 0.01 initialisation gives class
logits of +-30: among PointRend's 80 classes one always outscores the
person's +6 (with the recipe alone PointRend detects nobody at 800²), and
Keypoint R-CNN's raised person would put every score within float32's
resolution of 1, so it is not raised.

The photos: lit renders of upright bodies (pose N(0, 0.2²) with the root
unrotated, betas N(0, 0.5²)) at weak-perspective scale 0.8 ± 0.03 over
seeded noise, cut to the photo's aspect.
"""

import os

import torch

from portbench import detect_files

CLS_BIAS, MASK_BIAS, RPN_DELTA_SCALE, CLS_WEIGHT_SCALE = 6.0, 1.5, 0.1, 0.1


def person_biased(state: dict) -> dict:
    out = dict(state)
    # Keypoint R-CNN's person meets the background alone: a raised logit
    # would put every proposal's score within float32's resolution of 1.
    cls_bias = CLS_BIAS if out["roi_heads.box_predictor.cls_score.bias"].numel() > 2 else 0.0
    for key, rows, bias in (("roi_heads.box_predictor.cls_score.bias", slice(0, 1), cls_bias),
                            ("roi_heads.mask_coarse_head.prediction.bias", slice(0, 49),
                             MASK_BIAS),
                            ("roi_heads.mask_point_head.predictor.bias", slice(0, 1), MASK_BIAS)):
        if key in out:
            b = out[key].clone()
            b[rows] += bias
            out[key] = b
    for key, scale in (("proposal_generator.rpn_head.anchor_deltas.weight", RPN_DELTA_SCALE),
                       ("roi_heads.box_predictor.cls_score.weight", CLS_WEIGHT_SCALE)):
        out[key] = out[key] * scale
    return out


def write_detector_pkls(root: str, seed: int):
    """(keypoint pickle, PointRend pickle) of seeded, person-biased weights."""
    from straps_tpu_torch.perception import rcnn
    from straps_tpu_torch.perception.convert_d2 import save_d2_pkl

    paths = []
    for i, (cls, name) in enumerate(((rcnn.KeypointRCNN, "keypoint_rcnn.pkl"),
                                     (rcnn.PointRendRCNN, "pointrend_rcnn.pkl"))):
        with torch.device("meta"):
            model = cls()
        rcnn.init_random_weights(model, torch.Generator().manual_seed(seed + i))
        paths.append(os.path.join(root, name))
        save_d2_pkl(paths[-1], person_biased(model.state_dict()))
    return paths


@torch.no_grad()
def write_photos(smpl_dir: str, root: str, seed: int, traffic: dict, device) -> dict:
    """`png_photos` PNGs of `png_wh` and `jpeg_photos` JPEGs of `jpeg_wh`
    at `jpeg_quality` (PNGs where no JPEG encoder is installed), named
    photo_00, photo_01, ... in the predict path's order.  Returns the names
    and what wrote the JPEGs."""
    from straps_tpu_torch.render.vis import render_body_vis_batch
    from straps_tpu_torch.smpl.assets import load_assets
    from straps_tpu_torch.smpl.model import smpl_forward_axis_angle
    from straps_tpu_torch.utils.png import write_png

    os.makedirs(root, exist_ok=True)
    assets = load_assets(smpl_dir, device=device)
    g = torch.Generator().manual_seed(seed)
    lib = detect_files.jpeg_library()
    names, i = [], 0
    for kind in ("png", "jpeg"):
        n = int(traffic[f"{kind}_photos"])
        if n == 0:
            continue
        w, h = traffic[f"{kind}_wh"]
        poses = torch.randn(n, 72, generator=g) * 0.2
        poses[:, :3] = 0.0
        shapes = torch.randn(n, 10, generator=g) * 0.5
        cam = torch.tensor([0.8, 0.0, 0.0]) + torch.randn(n, 3, generator=g) * 0.03
        noise = torch.randint(0, 256, (n, w, w, 3), generator=g, dtype=torch.uint8)
        verts = smpl_forward_axis_angle(assets, shapes.to(device), poses.to(device)).vertices
        imgs = render_body_vis_batch(verts, cam.to(device), assets, img_wh=w,
                                     image=noise.to(device), rotate_x180=True).cpu().numpy()
        top = (w - h) // 2
        for img in imgs[:, top:top + h]:
            name = f"photo_{i:02d}"
            if kind == "jpeg" and lib is not None:
                detect_files.encode_jpeg(os.path.join(root, name + ".jpg"), img,
                                         traffic["jpeg_quality"])
            else:
                write_png(os.path.join(root, name + ".png"), img)
            names.append(name)
            i += 1
    return {"names": names, "jpeg_writer": lib}
