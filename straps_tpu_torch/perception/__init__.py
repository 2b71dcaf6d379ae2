"""Detector front end of the PyTorch port: Keypoint-RCNN and PointRend-RCNN
on a ResNet-50 FPN trunk and DensePose-RCNN on a ResNet-101 FPN trunk,
with detectron2's module and state-dict names (counterpart of
`straps_tpu/perception/`)."""
