"""Keypoint block sizes, joint tables and dataset constants.

A copy of ``bodyfitting_tpu/constants.py`` (the port imports nothing of
the JAX package).  These are published, dataset-defined tables, not
code.
"""

from __future__ import annotations

import numpy as np

# OpenPose keypoint block sizes
NUM_BODY_KP = 25           # OpenPose BODY_25
NUM_HAND_KP = 21           # per hand
NUM_FACE_KP = 68           # 17 contour + 51 inner landmarks (OpenPose order)
NUM_TOTAL_KP = NUM_BODY_KP + 2 * NUM_HAND_KP + NUM_FACE_KP  # 135

# OpenPose face JSON order is [17 contour, 51 inner]; the SMPL-X landmark
# head emits [51 inner, 17 contour].  This permutation reorders OpenPose GT
# into the model's order.
FACE_MAPPING = np.array(
    list(range(17, 17 + 51)) + list(range(0, 17)), dtype=np.int32
)

SMPLX_NUM_VERTS = 10475
SMPL_NUM_FACES = 13776
SMPLX_NUM_FACES = 20908

# Skeleton sizes
NUM_SMPL_JOINTS = 24        # SMPL kinematic tree
NUM_SMPLH_JOINTS = 52       # SMPL + 2x15 finger joints
NUM_SMPLX_JOINTS = 55       # SMPL-H + jaw + 2 eyes
NUM_HAND_JOINTS = 15        # finger joints per hand
NUM_FACE_LMKS = 51          # inner face landmarks
NUM_CONTOUR_LMKS = 17       # dynamic jawline landmarks

# HMR's crop: the input side and the virtual focal length of its camera
IMG_RES = 224
FOCAL_LENGTH = 5000.0

# ImageNet normalisation of the HMR input
IMG_NORM_MEAN = (0.485, 0.456, 0.406)
IMG_NORM_STD = (0.229, 0.224, 0.225)

# GeneBody dataset facts
GENEBODY_NUM_VIEWS = 48
GENEBODY_MASK_FRAMES = (1, 7, 13, 19, 25, 31, 37, 43)
GENEBODY_KEYFRAME = 25          # the view HMR initialises from
GENEBODY_SCENE_SCALE = 0.3      # constant scale prior
SMPL_NUM_VERTS = 6890

# RenderPeople: the scan's height over this is the constant scale prior
RENDERPEOPLE_PERSON_HEIGHT = 1.7

# The SPIN 49-joint superset: the first 25 names are the OpenPose BODY_25
# joints in OpenPose order, the other 24 dataset ground-truth joints.
JOINT_NAMES = [
    # 25 OpenPose joints, in OpenPose BODY_25 order
    "OP Nose", "OP Neck", "OP RShoulder", "OP RElbow", "OP RWrist",
    "OP LShoulder", "OP LElbow", "OP LWrist", "OP MidHip", "OP RHip",
    "OP RKnee", "OP RAnkle", "OP LHip", "OP LKnee", "OP LAnkle",
    "OP REye", "OP LEye", "OP REar", "OP LEar", "OP LBigToe",
    "OP LSmallToe", "OP LHeel", "OP RBigToe", "OP RSmallToe", "OP RHeel",
    # 24 ground-truth joints (superset across datasets)
    "Right Ankle", "Right Knee", "Right Hip", "Left Hip", "Left Knee",
    "Left Ankle", "Right Wrist", "Right Elbow", "Right Shoulder",
    "Left Shoulder", "Left Elbow", "Left Wrist", "Neck (LSP)",
    "Top of Head (LSP)", "Pelvis (MPII)", "Thorax (MPII)", "Spine (H36M)",
    "Jaw (H36M)", "Head (H36M)", "Nose", "Left Eye", "Right Eye",
    "Left Ear", "Right Ear",
]

JOINT_IDS = {name: i for i, name in enumerate(JOINT_NAMES)}

# Index of each superset joint inside [45 SMPL joints (24 skeleton, 21
# vertex-picked) ++ 9 extra-regressed joints].
JOINT_MAP = {
    "OP Nose": 24, "OP Neck": 12, "OP RShoulder": 17,
    "OP RElbow": 19, "OP RWrist": 21, "OP LShoulder": 16,
    "OP LElbow": 18, "OP LWrist": 20, "OP MidHip": 0,
    "OP RHip": 2, "OP RKnee": 5, "OP RAnkle": 8,
    "OP LHip": 1, "OP LKnee": 4, "OP LAnkle": 7,
    "OP REye": 25, "OP LEye": 26, "OP REar": 27,
    "OP LEar": 28, "OP LBigToe": 29, "OP LSmallToe": 30,
    "OP LHeel": 31, "OP RBigToe": 32, "OP RSmallToe": 33, "OP RHeel": 34,
    "Right Ankle": 8, "Right Knee": 5, "Right Hip": 45,
    "Left Hip": 46, "Left Knee": 4, "Left Ankle": 7,
    "Right Wrist": 21, "Right Elbow": 19, "Right Shoulder": 17,
    "Left Shoulder": 16, "Left Elbow": 18, "Left Wrist": 20,
    "Neck (LSP)": 47, "Top of Head (LSP)": 48,
    "Pelvis (MPII)": 49, "Thorax (MPII)": 50,
    "Spine (H36M)": 51, "Jaw (H36M)": 52,
    "Head (H36M)": 53, "Nose": 24, "Left Eye": 26,
    "Right Eye": 25, "Left Ear": 28, "Right Ear": 27,
}

# The permutation of [45 SMPL joints ++ 9 extra] into the SPIN layout.
SPIN_JOINT_PERMUTATION = np.array(
    [JOINT_MAP[name] for name in JOINT_NAMES], dtype=np.int32
)
