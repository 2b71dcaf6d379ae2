"""Predict cells over photos: `predict_3d(cfg, save_vis=False)` through
Keypoint R-CNN and PointRend R50-FPN from detectron2 pickles, as
`run_predict --silh-from pointrend --keypoint-checkpoint K
--silhouette-checkpoint S --no-vis` runs it.

Set-up writes the body model as an SMPL directory, the regressor's
checkpoint of seeded weights with the posed IEF head, the two detectors'
seeded person-biased pickles and the folder of photos (`detect_inputs`);
one call warms up.  Each unit predicts over the folder into the same out
directory: decode, both detectors in chunks of 8 at 800², selection,
proxies, regressor, npy files.  The check holds the silhouettes and joints
the last call wrote and every call's returned predictions against the
reference (`reference/detector.py`, then `reference/infer.py`).
"""

import contextlib
import os
import time

import numpy as np
import torch

from portbench import compare_detect, detect_files, detect_inputs, detector_counters, inputs
from portbench.reference import body as Bm
from portbench.reference import detector as D
from portbench.reference import infer

KEYS = compare_detect.KEYS


class Driver:
    work_name = "images"

    def __init__(self, cell, seed: int, device: str, tmp: str):
        self.setup_log = []
        t = time.perf_counter()
        self.cfg, traffic = cell.config, cell.traffic
        s_body, s_weights, s_det, s_photos = inputs.seeds(seed, 4)
        self.dev = torch.device(device)
        self.arrays = inputs.body_model(s_body)
        smpl_dir = inputs.write_smpl_dir(f"{tmp}/body", self.arrays)
        self.weights = inputs.seeded_checkpoint(self.cfg, self.arrays, s_weights, self.dev,
                                                f"{tmp}/model.pt")
        self.kp_pkl, self.pr_pkl = detect_inputs.write_detector_pkls(tmp, s_det)
        self.photos = f"{tmp}/photos"
        made = detect_inputs.write_photos(smpl_dir, self.photos, s_photos, traffic, self.dev)
        self.names, self.jpeg_writer = made["names"], made["jpeg_writer"]
        det = self.cfg["detectors"]
        self.out = f"{tmp}/out"
        self.pc = inputs.predict_config(
            self.cfg, f"{tmp}/model.pt", smpl_dir, input_dir=self.photos,
            silhouettes_from="pointrend", keypoint_checkpoint=self.kp_pkl,
            silhouette_checkpoint=self.pr_pkl, out_dir=self.out,
            detector_image_size=int(det["image_frame"]), detector_test_size=int(det["test_size"]),
            detector_post_nms_topk=int(self.cfg["detector_post_nms_topk"]),
            detector_max_detections=int(self.cfg["detector_max_detections"]),
            detector_score_thresh=float(det["score_thresh"]))
        self.flops_per_unit = detector_counters.predict_call_flops(self.cfg, len(self.names))
        if self.dev.type == "cuda":
            # The memory peak is the program's: the inputs' renders are not.
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        self.setup_log.append((f"inputs (JPEGs by {self.jpeg_writer or 'none: all PNG'})",
                               time.perf_counter() - t))
        t = time.perf_counter()
        self.calls = []
        self.unit()
        self.setup_log.append(("first call", time.perf_counter() - t))

    def unit(self) -> int:
        from straps_tpu_torch.predict.pipeline import predict_3d

        out = predict_3d(self.pc, save_vis=False, device=self.dev.type)
        self.calls.append({k: out[k] for k in KEYS})
        return len(out["names"])

    def traced_unit(self) -> int:
        from straps_tpu_torch.perception import ops

        reset = getattr(ops, "reset_nms_stats", None)
        if reset is not None:
            reset()
        return self.unit()

    def check(self) -> dict:
        return compare_detect.detect_numbers(self.program_outputs(), self.reference())

    def program_outputs(self) -> dict:
        """The silhouettes and joints of the last call's `<out>/proxies`, and
        every call's returned predictions."""
        root = os.path.join(self.out, "proxies")
        return {"sils": np.stack([np.load(os.path.join(root, f"{n}_silhouette.npy"))
                                  for n in self.names]),
                "joints": np.stack([np.load(os.path.join(root, f"{n}_joints2D.npy"))
                                    for n in self.names]),
                "calls": self.calls}

    def reference(self, trunk_dtype=torch.float32) -> dict:
        """The reference from the same photos and pickles: the detectors
        (their trunks in `trunk_dtype`), the selection, the proxies and
        the regressor, in float32."""
        det, frame = self.cfg["detectors"], int(self.cfg["detectors"]["image_frame"])
        imgs = [D.cv2_resize_linear(D.pad_to_square(detect_files.read_photo(p)), frame)
                for p in detect_files.photo_paths(self.photos)]
        sils, joints = D.proxies_of(
            imgs, detect_files.read_d2_pkl(self.kp_pkl, self.dev),
            detect_files.read_d2_pkl(self.pr_pkl, self.dev),
            int(self.cfg["detector_post_nms_topk"]), int(self.cfg["detector_max_detections"]),
            float(det["score_thresh"]), int(det["test_size"]), frame, trunk_dtype)
        return {"sils": sils, "joints": joints, "calls": [self.regress(sils, joints)]}

    def regress(self, sils, joints, fp8=False) -> dict:
        """The reference regressor on silhouettes and joints: the proxies,
        then the predictions (its encoder on float8 e4m3 operands, with
        every float32 product in TF32, where `fp8`: the cached predict
        cell's control)."""
        from portbench.calibrate import tf32

        body = Bm.body_tensors(self.arrays, self.dev)
        prox = infer.proxies(torch.as_tensor(sils, device=self.dev),
                             torch.as_tensor(joints, device=self.dev), int(self.cfg["img_wh"]))
        with tf32() if fp8 else contextlib.nullcontext():
            pred = infer.predict(prox, self.weights, body, self.cfg["model"]["resnet_layers"],
                                 self.cfg["model"]["ief_iters"], fp8=fp8)
        return {k: pred[k].cpu().numpy() for k in KEYS}
