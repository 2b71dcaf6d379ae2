"""Geometry: rotations, cameras, keypoints, alignment, crops, heatmaps
(counterpart of `straps_tpu/geometry/`).

`JAX_COUNTERPARTS` maps each name of `straps_tpu.geometry.__all__` to its
counterparts here: every one has its own name.
"""

from straps_tpu_torch.geometry.alignment import (
    compute_similarity_transform, procrustes_align, scale_and_translation_transform,
)
from straps_tpu_torch.geometry.bbox import (
    batch_crop_and_resize, crop_and_resize_padded, crop_and_resize_seg_joints,
    mask_bounding_box, pad_to_square,
)
from straps_tpu_torch.geometry.camera import (
    get_intrinsics_matrix, orthographic_project, perspective_project,
    weak_perspective_to_camera_translation,
)
from straps_tpu_torch.geometry.heatmaps import (
    convert_densepose_to_6part_lsp_labels, convert_multiclass_to_binary_labels,
    joints_to_gaussian_heatmaps,
)
from straps_tpu_torch.geometry.joints import (
    check_joints2d_visibility, normalise_keypoints, undo_keypoint_normalisation,
)
from straps_tpu_torch.geometry.rotations import (
    rodrigues, rot6d_to_rotmat, rotate_translate_points, rotmat_to_axis_angle, rotmat_to_rot6d,
)

__all__ = [
    "rot6d_to_rotmat", "rotmat_to_rot6d", "rodrigues", "rotmat_to_axis_angle",
    "rotate_translate_points", "orthographic_project", "get_intrinsics_matrix",
    "perspective_project", "weak_perspective_to_camera_translation",
    "joints_to_gaussian_heatmaps", "convert_multiclass_to_binary_labels",
    "convert_densepose_to_6part_lsp_labels", "pad_to_square", "compute_similarity_transform",
    "procrustes_align", "scale_and_translation_transform", "undo_keypoint_normalisation",
    "normalise_keypoints", "check_joints2d_visibility", "mask_bounding_box",
    "crop_and_resize_seg_joints", "crop_and_resize_padded", "batch_crop_and_resize",
]

JAX_COUNTERPARTS = {name: (name,) for name in __all__}
