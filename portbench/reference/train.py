"""The reference training step: synthetic batch, regressor in train mode,
SMPL on the predictions, the homoscedastic multi-task loss (with the soft
silhouette where the task is on), the backward pass and Adam, in float32.

`reference_steps` follows the program's first steps from the same initial
weights, rows and draws, and returns what the comparison reads: each
step's loss and task losses, each task's initial weight, the first step's
per-frame metrics, each leaf's first gradient norm, each leaf's change
after the last step, and each step's proxy silhouette and cropped 2D
joints.
"""

import math

import numpy as np
import torch

from portbench.reference import body as Bm
from portbench.reference import infer
from portbench.reference import regressor as R
from portbench.reference import synth


def init_log_vars(cfg, device):
    return {t: torch.tensor(np.float32(-np.log(cfg["init_loss_weights"][t] + 1e-6)),
                            device=device, requires_grad=True)
            for t in cfg["losses_on"]}


def soft_silhouette(verts, cam, wh, sigma=0.8, sharpness=2.0):
    v2d = Bm.to_pixels(Bm.orthographic(verts, cam), wh)
    xs = torch.arange(wh, dtype=torch.float32, device=verts.device) + 0.5
    dx, dy = xs - v2d[..., 0:1], xs - v2d[..., 1:2]
    gx = torch.exp(-(dx * dx) / (2.0 * sigma * sigma))
    gy = torch.exp(-(dy * dy) / (2.0 * sigma * sigma))
    acc = torch.bmm(gy.transpose(1, 2), gx)
    return 1.0 - torch.exp(-sharpness * acc / (2.0 * math.pi * sigma * sigma))


def loss(sd, log_vars, batch, body, cfg, depth, init, fp8=False, rows=None):
    """(total loss, {task: its weighted loss}, the predictions the per-frame
    metrics read).  `rows` is a planted fault: the loss reads only the
    batch's first `rows` rows, the predictions cover all of them."""
    wh = cfg["img_wh"]
    cam, pose6d, shape = R.forward(batch["proxy"], sd, depth, init, train=True,
                                   iters=cfg["model"]["ief_iters"], fp8=fp8)
    B = cam.shape[0]
    rot = Bm.rot6d_to_rotmat(pose6d.reshape(B, 24, 6))
    verts, joints = Bm.smpl(body, shape, rot[:, 1:], rot[:, 0:1])
    j14, coco = Bm.joint_sets(joints)
    preds = {"verts": verts, "joints3D": j14, "joints2D": Bm.orthographic(coco, cam),
             "rotmats": rot, "shape": shape}
    if rows is not None:
        cam, rot, verts, coco, j14, shape = (v[:rows] for v in (cam, rot, verts, coco, j14,
                                                                 shape))
        batch = {k: v[:rows] for k, v in batch.items()}
    total = torch.zeros((), dtype=torch.float32, device=cam.device)
    tasks = {}

    def add(task, mse):
        nonlocal total
        lv = log_vars[task]
        tasks[task] = mse * torch.exp(-lv)
        total = total + (tasks[task] + lv)

    if "verts" in log_vars:
        add("verts", torch.mean((verts - batch["verts"]) ** 2))
    if "joints2D" in log_vars:
        label = (2.0 * batch["joints2D"]) / wh - 1.0
        vis = batch["vis"].to(torch.float32)[..., None]
        count = torch.clamp(vis.sum() * 2.0, min=1.0)
        add("joints2D", torch.sum(((Bm.orthographic(coco, cam) - label) ** 2) * vis) / count)
    if "joints3D" in log_vars:
        add("joints3D", torch.mean((j14 - batch["joints3D"]) ** 2))
    if "shape_params" in log_vars:
        add("shape_params", torch.mean((shape - batch["shape"]) ** 2))
    if "pose_params" in log_vars:
        add("pose_params", torch.mean((rot - batch["rotmats"]) ** 2))
    if "silhouette" in log_vars:
        sw = cfg["silhouette_loss_wh"]
        add("silhouette", torch.mean((soft_silhouette(verts, cam, sw)
                                      - synth.silhouette_target(batch["proxy"], sw)) ** 2))
    return (total, {k: float(v.detach()) for k, v in tasks.items()},
            {k: v.detach() for k, v in preds.items()})


@torch.no_grad()
def step_metrics(cfg, body, preds, batch) -> dict:
    """The training step's per-frame metrics of its forward pass."""
    reposed, _ = Bm.smpl(body, preds["shape"])
    return infer.per_frame_metrics(cfg["metrics_to_track"], preds, batch, reposed,
                                   batch["reposed"], cfg["img_wh"])


class Adam:
    """torch's Adam (betas 0.9 / 0.999, eps 1e-8 outside the root), written out."""

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.params, self.lr, self.b1, self.b2, self.eps = params, lr, b1, b2, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self):
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(self.lr / c1 * m / (v.sqrt() / math.sqrt(c2) + self.eps))


def reference_steps(state: dict, param_names, body, cfg, rows, step_draws, fp8=False,
                    half=False):
    """Follow the program's first `len(rows)` steps.

    state: the initial state dict (parameters and BatchNorm statistics),
      which is left unchanged; param_names: the trainable leaves in the
      program's order; rows: [(pose (B, 72), shape (B, 10))] per step;
      step_draws: [draws] per step, as `synth.draws` makes them.
    `half` is a planted fault: each step's loss reads the first half of
    its batch, its per-frame metrics the whole of it.
    """
    dev = body["v_template"].device
    depth = cfg["model"]["resnet_layers"]
    sd = {k: v.detach().clone().float() for k, v in state.items()}
    for k in param_names:
        sd[k].requires_grad_(True)
    log_vars = init_log_vars(cfg, dev)
    leaves = [(k, sd[k]) for k in param_names] + [("log_var." + t, v)
                                                   for t, v in log_vars.items()]
    start = {k: v.detach().clone() for k, v in leaves}
    opt = Adam([v for _, v in leaves], cfg["lr"])
    init = R.initial_estimate(body["mean_pose_6d"], body["mean_shape"])
    out = {"losses": [], "tasks": [], "proxy_sil": [], "joints2D": [],
           "task_weights": {t: float(torch.exp(-v.detach())) for t, v in log_vars.items()}}
    for i, ((pose, shape), d) in enumerate(zip(rows, step_draws)):
        batch = synth.synthetic_batch(d, pose, shape, body, cfg)
        out["proxy_sil"].append(batch["proxy"][..., 0] > 0)
        out["joints2D"].append(batch["joints2D"])
        for _, v in leaves:
            v.grad = None
        total, tasks, preds = loss(sd, log_vars, batch, body, cfg, depth, init, fp8,
                                   rows=pose.shape[0] // 2 if half else None)
        total.backward()
        if i == 0:
            out["grad1"] = {k: float(torch.linalg.vector_norm(v.grad)) for k, v in leaves}
            out["frames1"] = {k: v.cpu().numpy() for k, v in
                              step_metrics(cfg, body, preds, batch).items()
                              if k in cfg["metrics_to_track"]}
        opt.step()
        out["losses"].append(float(total.detach()))
        out["tasks"].append(tasks)
    out["change"] = {k: float(torch.linalg.vector_norm(v.detach() - start[k]))
                     for k, v in leaves}
    return out
