"""Plain float32 body model, rotations and cameras of the reference.

Frozen copies of the port's plain formulas (SMPL blend shapes and linear
blend skinning over the 90-joint superset, Rodrigues, the 6D rotation,
perspective and weak-perspective cameras), written against a dict of body
model tensors.  Nothing here imports the program.
"""

import torch

PARENTS = [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21]
COCO_MAP = [24, 26, 25, 28, 27, 16, 17, 18, 19, 20, 21, 1, 2, 4, 5, 7, 8]
H36M_MAP = list(range(73, 90))
H36M_TO_J14 = [6, 5, 4, 1, 2, 3, 16, 15, 14, 11, 12, 13, 8, 10]
COCO_HIPS = [11, 12]
# Vertex ids of the 21 keypoints that follow the 24 tree joints: face 5,
# feet 6, finger tips 10.
EXTRA_VERTEX_IDS = [332, 6260, 2800, 4071, 583, 3216, 3226, 3387, 6617, 6624, 6787,
                    2746, 2319, 2445, 2556, 2673, 6191, 5782, 5905, 6016, 6133]
BODY_KEYS = ("v_template", "shapedirs", "posedirs", "J_regressor", "lbs_weights",
             "J_regressor_extra", "J_regressor_cocoplus", "J_regressor_h36m")


def body_tensors(arrays: dict, device) -> dict:
    """Body-model arrays (numpy) -> float32 tensors, int faces and parts."""
    out = {k: torch.as_tensor(arrays[k], dtype=torch.float32, device=device)
           for k in BODY_KEYS}
    out["faces"] = torch.as_tensor(arrays["faces"], dtype=torch.int64, device=device)
    out["face_parts"] = torch.as_tensor(arrays["face_parts"], dtype=torch.int32, device=device)
    out["mean_pose_6d"] = torch.as_tensor(arrays["mean_pose_6d"], dtype=torch.float32,
                                          device=device)
    out["mean_shape"] = torch.as_tensor(arrays["mean_shape"], dtype=torch.float32,
                                        device=device)
    return out


def rodrigues(aa: torch.Tensor) -> torch.Tensor:
    angle = torch.linalg.vector_norm(aa, dim=-1, keepdim=True)
    axis = aa / angle.clamp(min=1e-8)
    kx, ky, kz = axis[..., 0], axis[..., 1], axis[..., 2]
    z = torch.zeros_like(kx)
    K = torch.stack([torch.stack([z, -kz, ky], -1), torch.stack([kz, z, -kx], -1),
                     torch.stack([-ky, kx, z], -1)], -2)
    s = torch.sin(angle)[..., None]
    c = torch.cos(angle)[..., None]
    outer = axis[..., :, None] * axis[..., None, :]
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(K.shape)
    R = c * eye + s * K + (1.0 - c) * outer
    return torch.where(angle[..., None] < 1e-8, eye, R)


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    x = x.reshape(x.shape[:-1] + (3, 2))
    a1, a2 = x[..., 0], x[..., 1]
    b1 = a1 / torch.linalg.vector_norm(a1, dim=-1, keepdim=True).clamp(min=1e-12)
    b2u = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = b2u / torch.linalg.vector_norm(b2u, dim=-1, keepdim=True).clamp(min=1e-12)
    return torch.stack([b1, b2, torch.linalg.cross(b1, b2, dim=-1)], dim=-1)


def smpl(body: dict, betas, body_rotmats=None, glob_rotmats=None):
    """-> (vertices (B, V, 3), 90-joint superset (B, 90, 3)); no pose
    arguments: the rest pose."""
    B = betas.shape[0]
    V = body["v_template"].shape[0]
    eye = torch.eye(3, dtype=torch.float32, device=betas.device)
    v_shaped = body["v_template"][None] + torch.einsum("vct,bt->bvc", body["shapedirs"], betas)
    j_rest = torch.einsum("jv,bvc->bjc", body["J_regressor"], v_shaped)
    if body_rotmats is None and glob_rotmats is None:
        return _superset(body, v_shaped, j_rest)
    if body_rotmats is None:
        body_rotmats = eye.expand(B, 23, 3, 3)
    if glob_rotmats is None:
        glob_rotmats = eye.expand(B, 1, 3, 3)
    feat = (body_rotmats - eye).reshape(B, 23 * 9)
    v_posed = v_shaped + torch.matmul(feat, body["posedirs"]).reshape(B, V, 3)
    rot = torch.cat([glob_rotmats, body_rotmats], dim=1)
    rel = j_rest.clone()
    rel[:, 1:] -= j_rest[:, PARENTS[1:]]
    local = torch.zeros((B, 24, 4, 4), dtype=torch.float32, device=betas.device)
    local[..., :3, :3] = rot
    local[..., :3, 3] = rel
    local[..., 3, 3] = 1.0
    chain = [local[:, 0]]
    for j in range(1, 24):
        chain.append(torch.matmul(chain[PARENTS[j]], local[:, j]))
    G = torch.stack(chain, dim=1)
    A = G.clone()
    A[..., :3, 3] -= torch.einsum("bjik,bjk->bji", G[..., :3, :3], j_rest)
    T = torch.einsum("vj,bjpq->bvpq", body["lbs_weights"], A)
    verts = torch.einsum("bvpq,bvq->bvp", T[..., :3, :3], v_posed) + T[..., :3, 3]
    return _superset(body, verts, G[..., :3, 3])


def _superset(body, verts, tree_joints):
    reg = torch.cat([body["J_regressor_extra"], body["J_regressor_cocoplus"],
                     body["J_regressor_h36m"]], dim=0)
    joints = torch.cat([tree_joints, verts[:, EXTRA_VERTEX_IDS],
                        torch.einsum("jv,bvc->bjc", reg, verts)], dim=1)
    return verts, joints


def joint_sets(joints):
    """90-joint superset -> (LSP-14 3D joints, COCO-17 joints)."""
    return joints[:, H36M_MAP][:, H36M_TO_J14], joints[:, COCO_MAP]


def intrinsics(img_wh: int, focal: float, device) -> torch.Tensor:
    return torch.tensor([[focal, 0.0, img_wh / 2.0], [0.0, focal, img_wh / 2.0],
                         [0.0, 0.0, 1.0]], dtype=torch.float32, device=device)


def perspective(points, cam_t, K):
    p = points + cam_t[:, None, :]
    p = p / p[..., 2:3]
    return torch.einsum("ij,bkj->bki", K, p)[..., :2]


def orthographic(points, cam):
    return cam[:, 0:1][..., None] * (points[..., :2] + cam[:, None, 1:3])


def wp_to_cam_t(cam_wp, focal: float, res: int):
    tz = 2.0 * focal / (res * cam_wp[..., 0] + 1e-9)
    return torch.stack([cam_wp[..., 1], cam_wp[..., 2], tz], dim=-1)


def to_pixels(normalised, img_wh: int):
    return (normalised + 1.0) * (img_wh / 2.0)
