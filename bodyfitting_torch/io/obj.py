"""Wavefront OBJ writing: the outputs' plain mesh format.

Counterpart of ``bodyfitting_tpu/io/obj.py:save_obj``: ``v %.4f %.4f
%.4f`` lines, then 1-based ``f %d %d %d`` lines, byte for byte.  One
``%`` over the whole array formats a 10k-vertex mesh in milliseconds,
without the JAX package's native library.
"""

from __future__ import annotations

import numpy as np


def obj_text(verts: np.ndarray, faces: np.ndarray) -> str:
    """The OBJ file's text for ``verts [V, 3]`` and 0-based ``faces
    [F, 3]``."""
    v = np.asarray(verts).reshape(-1, 3)
    f = np.asarray(faces).reshape(-1, 3).astype(np.int64) + 1
    return (("v %.4f %.4f %.4f\n" * len(v)) % tuple(v.ravel().tolist())
            + ("f %d %d %d\n" * len(f)) % tuple(f.ravel().tolist()))


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    """Write ``verts`` and ``faces`` as an OBJ file."""
    with open(path, "w") as fh:
        fh.write(obj_text(verts, faces))
