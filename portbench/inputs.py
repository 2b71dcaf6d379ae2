"""Everything a run feeds the program and the reference, made from the
run's seed: the body model (the synthetic SMPL-topology fixture) written as
a real SMPL directory, pose and shape corpora, the regressor's weights,
checkpoints and cached proxies.  Only these inputs are handed to both
sides.
"""

import os
import pickle

import numpy as np
import torch

from portbench.reference import body as Bm
from portbench.reference import raster

NUM_VERTS, NUM_FACES, NUM_BETAS = 6890, 13776, 10
GRID_ROWS, GRID_COLS = 53, 130
# Temporaries of the reference rasteriser while it renders the inputs.
INPUT_RENDER_BYTES = 1 << 31
JOINT_TO_PART = [6, 4, 5, 6, 4, 5, 6, 4, 5, 6, 4, 5, 3, 6, 6, 3, 1, 2, 1, 2, 1, 2, 1, 2]


def seeds(seed: int, n: int):
    """`n` independent 31-bit seeds drawn from the run's seed (any size)."""
    return [int(s) for s in np.random.SeedSequence(seed).generate_state(n) % (1 << 31)]


def body_model(seed: int) -> dict:
    """The synthetic body model of SMPL's topology (6890 vertices, 13776
    faces, 24 joints, 10 betas, the 90-joint superset's regressors): a
    cylinder-grid humanoid whose pose blend shapes and extra regressors
    are drawn from `seed`.  A copy of the port's fixture generator."""
    rng = np.random.RandomState(seed)
    zz = np.linspace(0.0, 1.0, GRID_ROWS, dtype=np.float32)
    theta = np.linspace(0.0, 2.0 * np.pi, GRID_COLS, endpoint=False, dtype=np.float32)
    r = np.where(zz < 0.45, 0.10 + 0.04 * zz,
                 np.where(zz < 0.8, 0.16 + 0.05 * np.sin((zz - 0.45) * 9.0),
                          0.09 + 0.02 * np.cos((zz - 0.8) * 15.0))).astype(np.float32)
    ys = (zz * 1.7 - 0.85).astype(np.float32)
    v = np.zeros((NUM_VERTS, 3), np.float32)
    for i in range(GRID_ROWS):
        sl = slice(i * GRID_COLS, (i + 1) * GRID_COLS)
        v[sl, 0], v[sl, 1], v[sl, 2] = r[i] * np.cos(theta), ys[i], r[i] * np.sin(theta)
    i, j = np.meshgrid(np.arange(GRID_ROWS - 1), np.arange(GRID_COLS), indexing="ij")
    a, b = i * GRID_COLS + j, i * GRID_COLS + (j + 1) % GRID_COLS
    c, d = (i + 1) * GRID_COLS + j, (i + 1) * GRID_COLS + (j + 1) % GRID_COLS
    quads = np.stack([np.stack([a, b, c], -1), np.stack([b, d, c], -1)], 2).reshape(-1, 3)
    k = np.arange(1, GRID_COLS - 1)
    top0 = (GRID_ROWS - 1) * GRID_COLS
    faces = np.concatenate([quads, np.stack([np.zeros_like(k), k, k + 1], -1),
                            np.stack([np.full_like(k, top0), top0 + k + 1, top0 + k], -1)]
                           ).astype(np.int32)
    jh = np.array([0.55, 0.50, 0.50, 0.62, 0.28, 0.28, 0.70, 0.06, 0.06, 0.78, 0.01, 0.01,
                   0.84, 0.74, 0.74, 0.92, 0.72, 0.72, 0.55, 0.55, 0.40, 0.40, 0.35, 0.35],
                  np.float32)
    jx = np.array([0.0, 0.06, -0.06, 0.0, 0.07, -0.07, 0.0, 0.08, -0.08, 0.0, 0.08, -0.08,
                   0.0, 0.05, -0.05, 0.0, 0.17, -0.17, 0.30, -0.30, 0.45, -0.45, 0.55, -0.55],
                  np.float32)
    joints = np.stack([jx, jh * 1.7 - 0.85, np.zeros(24, np.float32)], axis=1)
    d2 = np.sum((v[None] - joints[:, None]) ** 2, axis=-1)
    jreg = np.exp(-d2 / 0.01)
    far = np.argsort(d2, axis=1)[:, 32:]
    np.put_along_axis(jreg, far, 0.0, axis=1)
    jreg = (jreg / jreg.sum(axis=1, keepdims=True)).astype(np.float32)
    w = np.exp(-np.sqrt(d2.T) / 0.05)
    mask = np.zeros_like(w)
    np.put_along_axis(mask, np.argsort(-w, axis=1)[:, :4], 1.0, axis=1)
    w = w * mask
    lbs = (w / w.sum(axis=1, keepdims=True)).astype(np.float32)
    radial = v.copy()
    radial[:, 1] = 0.0
    radial /= np.linalg.norm(radial, axis=1, keepdims=True) + 1e-8
    shapedirs = np.zeros((NUM_VERTS, 3, NUM_BETAS), np.float32)
    for t in range(NUM_BETAS):
        band = np.sin((v[:, 1] + 0.85) / 1.7 * np.pi * (t + 1))
        shapedirs[:, :, t] = 0.01 * band[:, None] * radial
        shapedirs[:, 1, t] += 0.005 * np.cos(t + v[:, 1])
    posedirs = rng.randn(23 * 9, NUM_VERTS * 3).astype(np.float32) * 1e-4

    def regressor(n, salt):
        rr = np.random.RandomState((seed + salt) % (1 << 32))
        reg = np.zeros((n, NUM_VERTS), np.float32)
        for jj in range(n):
            centre = rr.randint(0, NUM_VERTS)
            reg[jj, np.argsort(np.sum((v - v[centre]) ** 2, axis=1))[:16]] = 1.0 / 16.0
        return reg

    face_parts = np.asarray(JOINT_TO_PART, np.int32)[np.argmax(lbs, axis=1)][faces[:, 0]]
    return {"v_template": v, "shapedirs": shapedirs, "posedirs": posedirs,
            "J_regressor": jreg, "lbs_weights": lbs, "faces": faces,
            "parents": np.asarray(Bm.PARENTS, np.int32),
            "J_regressor_extra": regressor(9, 1), "J_regressor_cocoplus": regressor(19, 2),
            "J_regressor_h36m": regressor(17, 3), "face_parts": face_parts.astype(np.int32),
            "mean_pose_6d": np.tile(np.array([1, 0, 0, 0, 1, 0], np.float32), 24),
            "mean_shape": np.zeros(NUM_BETAS, np.float32)}


def write_smpl_dir(root: str, arrays: dict) -> str:
    """The body model as a real SMPL release: `smpl/SMPL_NEUTRAL.pkl`, the
    same body as `SMPL_MALE.pkl` and `SMPL_FEMALE.pkl` (hard links), and,
    beside the folder, the three extra joint regressors.  Per-face parts
    and the mean parameters follow from it as the loaders derive them.
    Returns the `smpl` folder."""
    smpl_dir = os.path.join(root, "smpl")
    os.makedirs(smpl_dir, exist_ok=True)
    parents = arrays["parents"].astype(np.int64)
    pkl = {"v_template": arrays["v_template"], "shapedirs": arrays["shapedirs"],
           "posedirs": arrays["posedirs"].T.reshape(NUM_VERTS, 3, -1),
           "J_regressor": arrays["J_regressor"], "weights": arrays["lbs_weights"],
           "f": arrays["faces"], "kintree_table": np.stack([parents, np.arange(24)])}
    neutral = os.path.join(smpl_dir, "SMPL_NEUTRAL.pkl")
    with open(neutral, "wb") as f:
        pickle.dump(pkl, f, protocol=4)
    for gender in ("MALE", "FEMALE"):
        os.link(neutral, os.path.join(smpl_dir, f"SMPL_{gender}.pkl"))
    for key, name in (("J_regressor_extra", "J_regressor_extra.npy"),
                      ("J_regressor_cocoplus", "cocoplus_regressor.npy"),
                      ("J_regressor_h36m", "J_regressor_h36m.npy")):
        np.save(os.path.join(root, name), arrays[key])
    return smpl_dir


def write_corpus(path: str, n: int, seed: int) -> str:
    """A pose and shape corpus in the released training npz's schema
    (fnames, poses (n, 72), shapes (n, 10)), as the port's fixture draws
    it: axis-angle N(0, 0.25²), the root N(0, 0.1²), betas N(0, 0.8²)."""
    rng = np.random.RandomState(seed)
    prefixes = ["amass", "h36m", "up3d", "3dpw"]
    poses = (rng.randn(n, 72) * 0.25).astype(np.float32)
    poses[:, :3] = rng.randn(n, 3).astype(np.float32) * 0.1
    shapes = (rng.randn(n, 10) * 0.8).astype(np.float32)
    fnames = np.array([f"{prefixes[i % 4]}_{i:06d}.npz" for i in range(n)])
    np.savez(path, fnames=fnames, poses=poses, shapes=shapes)
    return path


@torch.no_grad()
def regressor_weights(shapes: dict, seed: int, device) -> dict:
    """Weights for a regressor state dict of these {name: shape}, drawn on
    `device` in one call: convolution and linear weights N(0, 1/fan_in),
    biases and BatchNorm shifts 0, BatchNorm scales 1, running statistics
    (0, 1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dense = {k: s for k, s in shapes.items() if k.endswith("weight") and len(s) > 1}
    total = sum(int(np.prod(s)) for s in dense.values())
    noise = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for k, s in shapes.items():
        if k in dense:
            n = int(np.prod(s))
            fan_in = n // s[0]
            out[k] = noise[at:at + n].view(s) / float(np.sqrt(fan_in))
            at += n
        elif k.endswith("num_batches_tracked"):
            out[k] = torch.zeros(s, dtype=torch.int64, device=device)
        elif k.endswith("weight") or k.endswith("running_var"):
            out[k] = torch.ones(s, device=device)
        else:
            out[k] = torch.zeros(s, device=device)
    return out


@torch.no_grad()
def posed_head(weights: dict, mean_pose_6d, iters: int = 3, weight_scale: float = 0.1) -> dict:
    """The weights with the IEF head set so that its bodies are near the
    T-pose at camera scale 0.9 and fill the crop: `fc3`'s bias reaches the
    identity rotation (1, 0, 0, 1, 0, 0) from the mean pose over the
    iterations, its weight scaled so that the bodies still vary with the
    input."""
    out = dict(weights)
    ident = torch.tensor([1.0, 0.0, 0.0, 1.0, 0.0, 0.0]).repeat(24)
    w = weights["ief_module.fc3.weight"]
    bias = torch.zeros_like(weights["ief_module.fc3.bias"])
    bias[3:147] = ((ident - torch.as_tensor(np.asarray(mean_pose_6d), dtype=torch.float32))
                   / iters).to(bias.device)
    out["ief_module.fc3.weight"] = w * weight_scale
    out["ief_module.fc3.bias"] = bias
    return out


def predict_config(cfg: dict, ckpt: str, smpl_dir: str, **kw):
    """The port's `PredictConfig` for a configuration and a checkpoint."""
    from straps_tpu_torch.config import ModelConfig, PredictConfig

    return PredictConfig(checkpoint=ckpt, smpl_dir=smpl_dir, img_wh=int(cfg["img_wh"]),
                         model=ModelConfig(**cfg["model"]), **kw)


def seeded_checkpoint(cfg: dict, arrays: dict, seed: int, device, path: str) -> dict:
    """Write the checkpoint of seeded weights with the posed IEF head;
    returns its weights on `device`."""
    from straps_tpu_torch.models.regressor import build_regressor

    m = cfg["model"]
    shapes = {k: tuple(v.shape) for k, v in build_regressor(
        arrays["mean_pose_6d"], arrays["mean_shape"], m["resnet_in_channels"],
        m["resnet_layers"], m["ief_iters"]).state_dict().items()}
    weights = posed_head(regressor_weights(shapes, seed, device), arrays["mean_pose_6d"],
                         m["ief_iters"])
    write_checkpoint(path, weights)
    return weights


def write_checkpoint(path: str, weights: dict) -> str:
    """A training checkpoint of the port's `.pt` form carrying these
    weights as its best ones, with clean heatmaps."""
    cpu = {k: v.detach().cpu() for k, v in weights.items()}
    torch.save({"state": {"model": cpu}, "best_params": {}, "meta": {"heatmap_mode": "clean"}},
               path)
    return path


@torch.no_grad()
def rendered_bodies(arrays: dict, n: int, seed: int, size: int, device, chunk: int = 128):
    """n seeded bodies (poses N(0, 0.2²) axis-angle, betas N(0, 0.5²)) at
    camera (0, 0.2, 42), focal 5000 at 256 px scaled to `size`: their
    silhouettes (n, size, size) float32 and COCO joints (n, 17, 2), as
    numpy, rendered by the reference."""
    rng = np.random.RandomState(seed)
    poses = (rng.randn(n, 72) * 0.2).astype(np.float32)
    shapes = (rng.randn(n, 10) * 0.5).astype(np.float32)
    body = Bm.body_tensors(arrays, device)
    K = Bm.intrinsics(size, 5000.0 * size / 256.0, device)
    sils, j2d = [], []
    for s in range(0, n, chunk):
        po = torch.as_tensor(poses[s:s + chunk], device=device)
        sh = torch.as_tensor(shapes[s:s + chunk], device=device)
        t = torch.tensor([0.0, 0.2, 42.0], device=device).expand(po.shape[0], 3)
        rot = Bm.rodrigues(po.reshape(-1, 24, 3))
        verts, joints = Bm.smpl(body, sh, rot[:, 1:], rot[:, 0:1])
        sils.append(raster.silhouette(verts, t, K, body["faces"], size,
                                      temp_bytes=INPUT_RENDER_BYTES).cpu())
        j2d.append(Bm.perspective(Bm.joint_sets(joints)[1], t, K).cpu())
    return poses, shapes, torch.cat(sils).numpy(), torch.cat(j2d).numpy()


def write_cached_proxies(root: str, sils, j2d) -> list:
    """`<name>_silhouette.npy` and `<name>_joints2D.npy` per body, the
    predict path's cached form; returns the sorted names."""
    os.makedirs(root, exist_ok=True)
    names = [f"body_{i:03d}" for i in range(len(sils))]
    for name, sil, j in zip(names, sils, j2d):
        np.save(os.path.join(root, f"{name}_silhouette.npy"), sil.astype(np.float32))
        np.save(os.path.join(root, f"{name}_joints2D.npy"), j.astype(np.float32))
    return names
