"""2D keypoint normalisation and visibility (counterpart of
`straps_tpu/geometry/joints.py`)."""

import torch


def undo_keypoint_normalisation(normalised_keypoints: torch.Tensor,
                                img_wh: int) -> torch.Tensor:
    """[-1, 1] keypoint space -> pixel space."""
    return (normalised_keypoints + 1.0) * (img_wh / 2.0)


def normalise_keypoints(keypoints: torch.Tensor, img_wh: int) -> torch.Tensor:
    """Pixel space -> [-1, 1] keypoint space."""
    return (2.0 * keypoints) / img_wh - 1.0


def check_joints2d_visibility(joints2d: torch.Tensor, img_wh: int) -> torch.Tensor:
    """(B, J, 2) pixel joints -> (B, J) bool: both coordinates within
    [0, img_wh], bounds inclusive."""
    inside = (joints2d >= 0) & (joints2d <= img_wh)
    return inside.all(dim=-1)
