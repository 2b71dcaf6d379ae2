"""Predict cells over cached proxies: `predict_3d` with every output (the
npy files, the rend and reposed renders, the proxy images, the 3D
scatters), as `run_predict --input DIR --checkpoint X` runs it.

Set-up writes the body model as an SMPL directory, the checkpoint of
seeded weights with the posed IEF head, and a folder of cached proxies
(512² silhouettes and COCO joints of seeded bodies); one call warms up.
Each unit predicts over the folder into the same out directory.  The check
holds every call's returned predictions, the last call's npy files and the
body coverage of its rend and reposed renders against the reference.
"""

import os
import time
import zlib

import numpy as np
import torch

from portbench import compare, counters, inputs
from portbench.reference import body as Bm
from portbench.reference import infer

KEYS = ("verts", "shape", "pose_rotmats", "cam_wp")


def read_png_rgb(path: str) -> np.ndarray:
    """An 8-bit RGB PNG whose rows are unfiltered -> (H, W, 3) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    pos, idat, header = 8, b"", None
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            header = body
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h = int.from_bytes(header[0:4], "big"), int.from_bytes(header[4:8], "big")
    if header[8] != 8 or header[9] != 2:
        raise ValueError(f"{path}: not an 8-bit RGB PNG")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * 3)
    if rows[:, 0].any():
        raise ValueError(f"{path}: filtered rows")
    return rows[:, 1:].reshape(h, w, 3)


class Driver:
    work_name = "images"

    def __init__(self, cell, seed: int, device: str, tmp: str):
        self.setup_log = []
        t = time.perf_counter()
        self.cfg, traffic = cell.config, cell.traffic
        s_body, s_weights, s_data = inputs.seeds(seed, 3)
        self.dev = torch.device(device)
        self.arrays = inputs.body_model(s_body)
        smpl_dir = inputs.write_smpl_dir(f"{tmp}/body", self.arrays)
        self.weights = inputs.seeded_checkpoint(self.cfg, self.arrays, s_weights, self.dev,
                                                f"{tmp}/model.pt")
        _, _, self.sils, self.j2d = inputs.rendered_bodies(
            self.arrays, int(traffic["images"]), s_data, int(traffic["image_wh"]), self.dev)
        self.names = inputs.write_cached_proxies(f"{tmp}/proxies", self.sils, self.j2d)
        self.out = f"{tmp}/out"
        self.pc = inputs.predict_config(self.cfg, f"{tmp}/model.pt", smpl_dir,
                                        input_dir=f"{tmp}/proxies", silhouettes_from="cached",
                                        out_dir=self.out)
        self.flops_per_unit = len(self.names) * counters.regressor_flops(
            self.cfg["model"]["resnet_layers"], self.cfg["model"]["resnet_in_channels"],
            self.pc.img_wh, self.cfg["model"]["ief_iters"])
        if self.dev.type == "cuda":
            # The memory peak is the program's: the inputs' render is not.
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        self.setup_log.append(("inputs", time.perf_counter() - t))
        t = time.perf_counter()
        self.calls = []
        self.unit()
        self.setup_log.append(("first call", time.perf_counter() - t))

    def unit(self) -> int:
        from straps_tpu_torch.predict.pipeline import predict_3d

        out = predict_3d(self.pc, save_vis=True, device=self.dev.type)
        self.calls.append({k: out[k] for k in KEYS})
        return len(out["names"])

    def traced_unit(self) -> int:
        return self.unit()

    def check(self) -> dict:
        calls, files, fg = self.program_outputs()
        ref, ref_fg = self.reference()
        return compare.predict_numbers(calls, files, ref, fg, ref_fg)

    def program_outputs(self):
        """Every call's returned predictions, the last call's npy files and
        the body coverage of its rend and reposed renders."""
        files = {k: np.stack([np.load(os.path.join(self.out, f"{n}_{k}.npy"))
                              for n in self.names]) for k in KEYS}
        fg = {}
        for kind in ("rend", "reposed"):
            imgs = np.stack([read_png_rgb(os.path.join(self.out, "rend_vis", f"{kind}_{n}.png"))
                             for n in self.names])
            fg[kind] = (imgs != 255).any(axis=-1)
        return self.calls, files, fg

    def reference(self, fp8=False):
        body = Bm.body_tensors(self.arrays, self.dev)
        wh = self.pc.img_wh
        prox = infer.proxies(torch.as_tensor(self.sils, device=self.dev),
                             torch.as_tensor(self.j2d, device=self.dev), wh)
        pred = infer.predict(prox, self.weights, body, self.cfg["model"]["resnet_layers"],
                             self.cfg["model"]["ief_iters"], fp8=fp8)
        reposed_cam = torch.tensor(infer.REPOSED_CAM_WP, device=self.dev).expand(len(prox), 3)
        fg = {"rend": infer.vis_foreground(pred["verts"], pred["cam_wp"], body, wh),
              "reposed": infer.vis_foreground(pred["reposed_verts"], reposed_cam, body, wh,
                                              rotate_x180=True)}
        return ({k: pred[k].cpu().numpy() for k in KEYS},
                {k: v.cpu().numpy() for k, v in fg.items()})
