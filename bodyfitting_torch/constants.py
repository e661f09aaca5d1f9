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
