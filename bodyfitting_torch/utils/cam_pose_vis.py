"""Camera-pose debug visualisation: camera frusta as an OBJ.

Counterpart of ``bodyfitting_tpu/utils/cam_pose_vis.py`` (host numpy):
each camera becomes a small pyramid (apex at the camera centre, base on
the image plane at a chosen depth) plus an up-indicator triangle, written
as one OBJ for inspection in any mesh viewer.
"""

from __future__ import annotations

import numpy as np


def frustum_vertices(c2w: np.ndarray, K: np.ndarray, img_wh=(512, 512),
                     depth: float = 0.3) -> np.ndarray:
    """5 frustum corners (apex + 4 image-plane corners) in world space."""
    w, h = img_wh
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    corners_px = np.array(
        [[0, 0], [w, 0], [w, h], [0, h]], np.float64
    )
    rays = np.stack(
        [
            (corners_px[:, 0] - cx) / fx,
            (corners_px[:, 1] - cy) / fy,
            np.ones(4),
        ],
        axis=1,
    ) * depth
    pts_cam = np.concatenate([np.zeros((1, 3)), rays], axis=0)  # apex first
    R, t = np.asarray(c2w)[:3, :3], np.asarray(c2w)[:3, 3]
    return pts_cam @ R.T + t


def cam_pose_vis(
    output_path: str,
    c2ws: np.ndarray,
    Ks: np.ndarray,
    img_wh=(512, 512),
    depth: float = 0.3,
) -> None:
    """Write all camera frusta into one OBJ (lines as degenerate faces)."""
    verts, faces = [], []
    for i in range(len(c2ws)):
        K = Ks[i] if np.ndim(Ks) == 3 else Ks
        base = len(verts)
        pts = frustum_vertices(c2ws[i], K, img_wh, depth)
        # up-indicator: small triangle above the top edge of the base
        top_mid = (pts[1] + pts[2]) / 2
        up = top_mid + (top_mid - (pts[3] + pts[4]) / 2) * 0.25
        verts.extend(list(pts) + [up])
        a, b, c, d, e, u = (base, base + 1, base + 2, base + 3, base + 4,
                            base + 5)
        faces += [
            [a, b, c], [a, c, d], [a, d, e], [a, e, b],  # side faces
            [b, c, u],                                   # up indicator
        ]
    with open(output_path, "w") as f:
        for v in verts:
            f.write("v %.6f %.6f %.6f\n" % (v[0], v[1], v[2]))
        for face in np.asarray(faces) + 1:
            f.write("f %d %d %d\n" % (face[0], face[1], face[2]))
