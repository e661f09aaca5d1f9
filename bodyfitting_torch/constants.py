"""Keypoint block sizes and dataset constants the fit path reads.

A copy of the entries of ``bodyfitting_tpu/constants.py`` this package
needs (the port imports nothing of the JAX package).  These are
published, dataset-defined tables, not code.
"""

from __future__ import annotations

import numpy as np

# OpenPose keypoint block sizes
NUM_BODY_KP = 25           # OpenPose BODY_25
NUM_HAND_KP = 21           # per hand
NUM_FACE_KP = 68           # 17 contour + 51 inner landmarks (OpenPose order)

# OpenPose face JSON order is [17 contour, 51 inner]; the SMPL-X landmark
# head emits [51 inner, 17 contour].  This permutation reorders OpenPose GT
# into the model's order.
FACE_MAPPING = np.array(
    list(range(17, 17 + 51)) + list(range(0, 17)), dtype=np.int32
)

SMPLX_NUM_VERTS = 10475

# GeneBody dataset facts
GENEBODY_NUM_VIEWS = 48
GENEBODY_MASK_FRAMES = (1, 7, 13, 19, 25, 31, 37, 43)
GENEBODY_SCENE_SCALE = 0.3      # constant scale prior
SMPL_NUM_VERTS = 6890

# RenderPeople: the scan's height over this is the constant scale prior
RENDERPEOPLE_PERSON_HEIGHT = 1.7

# The SPIN 49-joint layout, as indices into [45 SMPL joints (24 skeleton,
# 21 vertex-picked) ++ 9 extra-regressed joints]; the first 25 rows are
# the OpenPose BODY_25 joints in OpenPose order.
SPIN_JOINT_PERMUTATION = np.array(
    [24, 12, 17, 19, 21, 16, 18, 20, 0, 2, 5, 8, 1, 4, 7, 25, 26, 27, 28,
     29, 30, 31, 32, 33, 34, 8, 5, 45, 46, 4, 7, 21, 19, 17, 16, 18, 20, 47,
     48, 49, 50, 51, 52, 53, 24, 26, 25, 28, 27], dtype=np.int32
)
