"""OpenPose JSON ingestion and keypoint packing (host-side numpy).

Counterpart of ``bodyfitting_tpu/io/openpose.py``: per-view JSON files of
the OpenPose binary (``people[*].pose_keypoints_2d``,
``hand_{left,right}_keypoints_2d``, ``face_keypoints_2d``) are parsed,
keeping the person with the highest summed confidence; a sequence of
per-view dicts becomes the padded ``[Vw, K, 3]`` array plus view mask
that the keypoint loss consumes, with the face block permuted into model
order up front.
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional, Sequence

import numpy as np

from bodyfitting_torch.constants import (
    FACE_MAPPING,
    NUM_BODY_KP,
    NUM_FACE_KP,
    NUM_HAND_KP,
)


def load_openpose(json_path: str, only_one: bool = True):
    """One OpenPose JSON as ``{pose, hand_left, hand_right, face}`` arrays
    ``[n, 3]`` (None when nobody was detected).  With ``only_one`` the
    person with the highest summed confidence wins; otherwise a list of
    every person's dict."""
    with open(json_path) as f:
        doc = json.load(f)
    parsed = []
    for person in doc.get("people", []):
        blocks = {}
        for key, flat in person.items():
            if "keypoints" not in key:
                continue
            arr = np.reshape(np.asarray(flat, dtype=np.float32), -1)
            if arr.size == 0:
                continue
            dims = re.findall(r"([2-9]d)", key)
            dim = int(dims[-1][0]) if dims else 2
            if arr.size % (dim + 1) == 0:
                arr = arr.reshape(-1, dim + 1)
                if np.abs(arr[:, -1]).max() <= 0:
                    continue                  # all-zero confidence block
            elif arr.size % dim == 0:
                arr = arr.reshape(-1, dim)
            else:
                arr = arr[: (arr.size // dim) * dim].reshape(-1, dim)
            blocks[key.replace("_keypoints", "").replace(f"_{dim}d", "")] = arr
        if blocks:
            parsed.append(blocks)
    if not parsed:
        return None
    if not only_one:
        return parsed
    scores = [sum(float(b[:, -1].sum()) for b in p.values()) for p in parsed]
    return parsed[int(np.argmax(scores))]


def load_openpose_dir(openpose_dir: str):
    """Every per-view JSON of a frame, in sorted file-name order."""
    names = sorted(n for n in os.listdir(openpose_dir) if n.endswith(".json"))
    return [load_openpose(os.path.join(openpose_dir, n)) for n in names]


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
