"""SMPL body model: blend shapes + linear blend skinning
(counterpart of `straps_tpu/smpl/model.py`).

Outputs the 90-joint superset (layout in `straps_tpu_torch.constants`).
Float32 throughout; on CUDA the entry points switch TF32 off
(`utils/device.py`) so the products stay full float32, as the reference's
`precision="highest"`.
"""

from typing import NamedTuple, Optional, Tuple

import torch

from straps_tpu_torch import constants as C
from straps_tpu_torch.geometry.rotations import rodrigues
from straps_tpu_torch.smpl.assets import SmplAssets
from straps_tpu_torch.utils.device import device_constant

_EXTRA_IDS = tuple(C.SMPL_VERTEX_IDS[k] for k in C.SMPL_EXTRA_KEYPOINT_ORDER)


def device_index(ids: tuple, device: torch.device) -> torch.Tensor:
    """The int64 index tensor of `ids` on `device`, made once
    (`utils/device.py::device_constant`): indexing with it gathers what
    indexing with the list gathers, without the host-to-device copy (and
    its wait) that a list costs on every call, so that a CUDA graph can
    capture the gather."""
    return device_constant(ids, torch.int64, device)


class SmplOutput(NamedTuple):
    vertices: torch.Tensor        # (B, V, 3)
    joints: torch.Tensor          # (B, 90, 3) superset
    tree_joints: torch.Tensor     # (B, 24, 3) posed kinematic joints


def _rigid_transforms(rotmats: torch.Tensor, joints: torch.Tensor,
                      parents: tuple) -> Tuple[torch.Tensor, torch.Tensor]:
    """World transforms down the kinematic tree.

    Args:
      rotmats: (B, 24, 3, 3) local rotations (root first).
      joints: (B, 24, 3) rest-pose joints.
    Returns:
      A (B, 24, 4, 4) skinning transforms (rest joint removed) and
      G (B, 24, 4, 4) world transforms.
    """
    B, J = rotmats.shape[:2]
    rel = joints.clone()
    rel[:, 1:] -= joints[:, device_index(tuple(parents[1:]), joints.device)]
    local = torch.zeros((B, J, 4, 4), dtype=rotmats.dtype, device=rotmats.device)
    local[..., :3, :3] = rotmats
    local[..., :3, 3] = rel
    local[..., 3, 3] = 1.0
    transforms = [local[:, 0]]
    for j in range(1, J):
        transforms.append(torch.matmul(transforms[parents[j]], local[:, j]))
    G = torch.stack(transforms, dim=1)
    Gj = torch.einsum("bjik,bjk->bji", G[..., :3, :3], joints)
    A = G.clone()
    A[..., :3, 3] -= Gj
    return A, G


def smpl_forward(assets: SmplAssets, betas: torch.Tensor,
                 body_pose_rotmats: Optional[torch.Tensor] = None,
                 glob_rotmats: Optional[torch.Tensor] = None) -> SmplOutput:
    """Batched SMPL forward.

    Args:
      betas: (B, 10).
      body_pose_rotmats: (B, 23, 3, 3), or None for the rest pose.
      glob_rotmats: (B, 1, 3, 3), or None for identity.
    Returns:
      SmplOutput with vertices (B, V, 3) and the 90-joint superset.
    """
    B = betas.shape[0]
    V = assets.num_verts
    dtype = assets.v_template.dtype
    eye = torch.eye(3, dtype=dtype, device=betas.device)

    v_shaped = assets.v_template[None] + torch.einsum(
        "vct,bt->bvc", assets.shapedirs, betas)
    joints_rest = torch.einsum("jv,bvc->bjc", assets.J_regressor, v_shaped)

    if body_pose_rotmats is None and glob_rotmats is None:
        # Identity pose: the pose blend shapes vanish and every skinning
        # transform is [I | 0], so the skinned mesh is v_shaped and the tree
        # joints are the rest joints (the general path differs by ~1 ulp of
        # float re-association).
        return _joint_superset_output(assets, v_shaped, joints_rest)
    if body_pose_rotmats is None:
        body_pose_rotmats = eye.expand(B, 23, 3, 3)
    if glob_rotmats is None:
        glob_rotmats = eye.expand(B, 1, 3, 3)

    pose_feature = (body_pose_rotmats - eye).reshape(B, 23 * 9)
    v_posed = v_shaped + torch.matmul(pose_feature, assets.posedirs).reshape(B, V, 3)

    rotmats = torch.cat([glob_rotmats, body_pose_rotmats], dim=1)
    A, G = _rigid_transforms(rotmats, joints_rest, assets.parents)

    # T_v = sum_j w_vj A_j, then verts = T_v [v; 1].
    T = torch.einsum("vj,bjpq->bvpq", assets.lbs_weights, A)
    verts = torch.einsum("bvpq,bvq->bvp", T[..., :3, :3], v_posed) + T[..., :3, 3]
    return _joint_superset_output(assets, verts, G[..., :3, 3])


def _joint_superset_output(assets: SmplAssets, verts: torch.Tensor,
                           tree_joints: torch.Tensor) -> SmplOutput:
    """24 tree joints + 21 vertex keypoints + 45 regressed joints."""
    picked = verts[:, device_index(_EXTRA_IDS, verts.device), :]
    reg = torch.cat([assets.J_regressor_extra, assets.J_regressor_cocoplus,
                     assets.J_regressor_h36m], dim=0)          # (45, V)
    regressed = torch.einsum("jv,bvc->bjc", reg, verts)
    joints = torch.cat([tree_joints, picked, regressed], dim=1)
    return SmplOutput(vertices=verts, joints=joints, tree_joints=tree_joints)


def smpl_forward_axis_angle(assets: SmplAssets, betas: torch.Tensor,
                            pose_axis_angle: torch.Tensor) -> SmplOutput:
    """SMPL forward from a flat (B, 72) axis-angle pose, root first."""
    B = pose_axis_angle.shape[0]
    rotmats = rodrigues(pose_axis_angle.reshape(B, 24, 3))
    return smpl_forward(assets, betas, body_pose_rotmats=rotmats[:, 1:],
                        glob_rotmats=rotmats[:, 0:1])


def select_joint_sets(joints_all: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """90-joint superset -> (H36M-LSP14 3D joints, COCO17 joints)."""
    dev = joints_all.device
    h36m = joints_all[:, device_index(tuple(C.ALL_JOINTS_TO_H36M_MAP), dev)]
    return (h36m[:, device_index(tuple(C.H36M_TO_J14), dev)],
            joints_all[:, device_index(tuple(C.ALL_JOINTS_TO_COCO_MAP), dev)])
