"""Joint-convention and body-model constants of the ported paths.

A copy of the tables of `straps_tpu/constants.py` that this package needs
(the port imports nothing of `straps_tpu`).  The joint index maps must match
the reference exactly for metric parity.  The body model outputs a 90-joint
superset:
  [0:24)   SMPL kinematic joints
  [24:45)  vertex-picked keypoints (face 5 + feet 6 + finger tips 10)
  [45:54)  9 "extra" regressed joints
  [54:73)  19 cocoplus regressed joints
  [73:90)  17 H36M regressed joints
"""

NUM_VERTS = 6890
NUM_FACES = 13776
NUM_BETAS = 10

# The SMPL kinematic tree: each joint's parent (-1 for the root).
SMPL_PARENTS = [
    -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21
]

# Superset -> 17 COCO joints.
ALL_JOINTS_TO_COCO_MAP = [24, 26, 25, 28, 27, 16, 17, 18, 19, 20, 21, 1, 2, 4, 5, 7, 8]
# Superset -> 17 H36M joints.
ALL_JOINTS_TO_H36M_MAP = list(range(73, 90))
# 17 H36M joints -> 14 LSP joints.
H36M_TO_J14 = [6, 5, 4, 1, 2, 3, 16, 15, 14, 11, 12, 13, 8, 10]
# COCO hips: the training proxy's joint noise gives them their own range.
COCO_HIP_JOINTS = [11, 12]

# Vertex ids of the 21 keypoints appended after the 24 kinematic joints.
SMPL_VERTEX_IDS = {
    "nose": 332, "reye": 6260, "leye": 2800, "rear": 4071, "lear": 583,
    "LBigToe": 3216, "LSmallToe": 3226, "LHeel": 3387,
    "RBigToe": 6617, "RSmallToe": 6624, "RHeel": 6787,
    "lthumb": 2746, "lindex": 2319, "lmiddle": 2445, "lring": 2556,
    "lpinky": 2673,
    "rthumb": 6191, "rindex": 5782, "rmiddle": 5905, "rring": 6016,
    "rpinky": 6133,
}
SMPL_EXTRA_KEYPOINT_ORDER = [
    "nose", "reye", "leye", "rear", "lear",
    "LBigToe", "LSmallToe", "LHeel", "RBigToe", "RSmallToe", "RHeel",
    "lthumb", "lindex", "lmiddle", "lring", "lpinky",
    "rthumb", "rindex", "rmiddle", "rring", "rpinky",
]

# 6-body-part segmentation convention: 0=background, 1=left arm,
# 2=right arm, 3=head, 4=left leg, 5=right leg, 6=torso.
PART_LEFT_ARM, PART_RIGHT_ARM, PART_HEAD = 1, 2, 3
PART_LEFT_LEG, PART_RIGHT_LEG, PART_TORSO = 4, 5, 6

# SMPL kinematic joint -> body part (per-face part ids of real SMPL files
# that ship without the colour-cube assets).
SMPL_JOINT_TO_PART = [
    PART_TORSO, PART_LEFT_LEG, PART_RIGHT_LEG, PART_TORSO,         # 0-3
    PART_LEFT_LEG, PART_RIGHT_LEG, PART_TORSO, PART_LEFT_LEG,      # 4-7
    PART_RIGHT_LEG, PART_TORSO, PART_LEFT_LEG, PART_RIGHT_LEG,     # 8-11
    PART_HEAD, PART_TORSO, PART_TORSO, PART_HEAD,                  # 12-15
    PART_LEFT_ARM, PART_RIGHT_ARM, PART_LEFT_ARM, PART_RIGHT_ARM,  # 16-19
    PART_LEFT_ARM, PART_RIGHT_ARM, PART_LEFT_ARM, PART_RIGHT_ARM,  # 20-23
]

# DensePose 24-part -> LSP 6-part label map (reference
# utils/label_conversions.py:8-36).  Index = DensePose class (1..24).
DENSEPOSE_TO_6PART = [
    0,  # 0: background
    6, 6, 2, 1, 4, 5, 5, 4, 5, 4, 5, 4, 5, 4, 1, 2, 1, 2, 1, 2, 1, 2, 3, 3,
]
