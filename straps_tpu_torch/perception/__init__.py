"""Detector front end of the PyTorch port: Keypoint-RCNN and PointRend-RCNN
on a ResNet-50 FPN trunk and DensePose-RCNN on a ResNet-101 FPN trunk,
with detectron2's module and state-dict names (counterpart of
`straps_tpu/perception/`).

`JAX_COUNTERPARTS` maps each name of `straps_tpu.perception.__all__` to
its counterparts here, or to why there is none.  A detectron2 state maps
onto a detector module (`load_detector_state`), where the JAX package
converts it into a flax variable tree.
"""

from straps_tpu_torch.perception.convert_d2 import load_d2_pkl, load_detector_state
from straps_tpu_torch.perception.densepose_structures import (
    DensePoseDataRelative, DensePoseTransformData, load_transform_data, rle_decode, rle_encode,
)
from straps_tpu_torch.perception.frontend import (
    get_largest_centred_box_index, get_largest_centred_mask_index, predict_joints2d,
    predict_silhouette,
)
from straps_tpu_torch.perception.rcnn import (
    DEFAULT_IMAGE_SIZE, DETECTOR_TEST_SIZE, DensePoseRCNN, KeypointRCNN, PointRendRCNN,
    normalise_image,
)

__all__ = [
    "KeypointRCNN", "PointRendRCNN", "DensePoseRCNN", "normalise_image", "DEFAULT_IMAGE_SIZE",
    "DETECTOR_TEST_SIZE", "get_largest_centred_box_index", "get_largest_centred_mask_index",
    "predict_joints2d", "predict_silhouette", "load_detector_state", "load_d2_pkl",
    "DensePoseDataRelative", "DensePoseTransformData", "load_transform_data", "rle_decode",
    "rle_encode",
]

JAX_COUNTERPARTS = {
    **{name: (name,) for name in __all__ if name != "load_detector_state"},
    "DetectionTrunk": "no module of its own: the shared backbone, RPN and box head are "
                      "the detectors' common base class and its `trunk` method "
                      "(`rcnn.py::_DetectorBase.trunk`)",
    "make_apply_fn": "a jit wrapper that passes the weights as an argument; a torch "
                     "module is called directly",
    "convert_d2_state": ("load_detector_state",),
}
