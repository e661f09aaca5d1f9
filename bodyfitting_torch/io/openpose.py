"""OpenPose keypoint packing (host-side numpy).

Counterpart of ``bodyfitting_tpu/io/openpose.py:pack_keypoints``: a
sequence of per-view OpenPose dicts becomes the padded ``[Vw, K, 3]``
array plus view mask that the keypoint loss consumes, with the face block
permuted into model order up front.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from bodyfitting_torch.constants import (
    FACE_MAPPING,
    NUM_BODY_KP,
    NUM_FACE_KP,
    NUM_HAND_KP,
)


def pack_keypoints(
    keypoints: Sequence[Optional[dict]],
    use_hand_face: bool = False,
    num_views: Optional[int] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-view OpenPose dicts -> padded ``[Vw, K, 3]`` + view mask.

    K = 25 (body) or 135 (body+hands+face).  Missing views (None) and
    missing blocks get confidence 0, which zeroes their loss contribution.
    The face block is permuted into model order (51 inner, 17 contour).
    """
    K = NUM_BODY_KP + (2 * NUM_HAND_KP + NUM_FACE_KP if use_hand_face else 0)
    Vw = num_views or len(keypoints)
    out = np.zeros((Vw, K, 3), np.float32)
    view_mask = np.zeros((Vw,), np.float32)

    def fill(dst, block, n):
        if block is None:
            return
        block = np.asarray(block, np.float32)
        if block.shape[1] == 2:  # no confidence column -> assume 1
            block = np.concatenate(
                [block, np.ones_like(block[:, :1])], axis=1
            )
        m = min(n, block.shape[0])
        dst[:m] = block[:m]

    for i, kp in enumerate(keypoints[:Vw]):
        if kp is None or "pose" not in kp:
            continue
        view_mask[i] = 1.0
        fill(out[i, :NUM_BODY_KP], kp.get("pose"), NUM_BODY_KP)
        if use_hand_face:
            o = NUM_BODY_KP
            fill(out[i, o:o + NUM_HAND_KP], kp.get("hand_left"), NUM_HAND_KP)
            o += NUM_HAND_KP
            fill(out[i, o:o + NUM_HAND_KP], kp.get("hand_right"), NUM_HAND_KP)
            o += NUM_HAND_KP
            face = kp.get("face")
            if face is not None and face.shape[0] >= NUM_FACE_KP:
                fill(out[i, o:o + NUM_FACE_KP], face[FACE_MAPPING],
                     NUM_FACE_KP)
    return out, view_mask
