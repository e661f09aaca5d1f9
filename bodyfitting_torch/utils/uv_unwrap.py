"""Self-contained UV atlas generation.

Counterpart of ``bodyfitting_tpu/utils/uv_unwrap.py`` (:27-99).  The
licensed SMPL/SMPL-X UV templates are not in the repository; this makes
texture fitting work without them: every face gets its own
margin-separated triangular chart, two per cell of a square grid, so no
two faces share a texel.  Per-face charts are as expressive for the
texture fit as the reference renderer's per-face texture cubes; only the
texel allocation differs.
"""

from __future__ import annotations

import math

import numpy as np


def per_face_atlas(
    num_faces: int, margin_frac: float = 0.125
) -> tuple[np.ndarray, np.ndarray]:
    """Pack ``num_faces`` triangular charts into the unit UV square.

    Two faces per grid cell (lower-left / upper-right right triangles),
    inset by ``margin_frac`` of the cell side so charts never touch, not
    even across the cell diagonal.

    Returns ``(uvs [3*num_faces, 2] float32 in (0, 1), face_uvs
    [num_faces, 3] int32)`` with ``face_uvs[f] = (3f, 3f+1, 3f+2)``.
    """
    if num_faces <= 0:
        raise ValueError("num_faces must be positive")
    cells = int(math.ceil(math.sqrt(math.ceil(num_faces / 2))))
    c = 1.0 / cells
    m = margin_frac * c
    idx = np.arange(num_faces)
    cell_id = idx // 2
    cx = (cell_id % cells).astype(np.float32) * c
    cy = (cell_id // cells).astype(np.float32) * c
    lower = (idx % 2) == 0
    # lower-left triangle: right angle at (m, m); legs end 2m short of the
    # far corners so the diagonal stays >m away from the upper chart
    lo = np.stack(
        [
            np.stack([cx + m, cy + m], -1),
            np.stack([cx + c - 2 * m, cy + m], -1),
            np.stack([cx + m, cy + c - 2 * m], -1),
        ],
        axis=1,
    )
    # upper-right triangle: right angle at (c-m, c-m)
    hi = np.stack(
        [
            np.stack([cx + c - m, cy + c - m], -1),
            np.stack([cx + 2 * m, cy + c - m], -1),
            np.stack([cx + c - m, cy + 2 * m], -1),
        ],
        axis=1,
    )
    uvs = np.where(lower[:, None, None], lo, hi).astype(np.float32)
    face_uvs = np.arange(3 * num_faces, dtype=np.int32).reshape(
        num_faces, 3
    )
    return uvs.reshape(3 * num_faces, 2), face_uvs


def make_uv_template(
    verts: np.ndarray,
    faces: np.ndarray,
    path: str | None = None,
    margin_frac: float = 0.125,
) -> tuple[np.ndarray, np.ndarray]:
    """A per-face atlas for a mesh, the stand-in for the reference's
    licensed ``smpl_uv.obj`` (whose ``vt`` / ``f`` lines the texture stage
    reads): ``(uvs, face_uvs)``, also written as an OBJ template (no
    texture) when ``path`` is given.
    """
    faces = np.asarray(faces)
    uvs, face_uvs = per_face_atlas(len(faces), margin_frac)
    if path is not None:
        from bodyfitting_torch.io.obj import save_obj_uv

        save_obj_uv(path, np.asarray(verts), faces, uvs, face_uvs)
    return uvs, face_uvs
