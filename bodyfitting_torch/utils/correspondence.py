"""Vertex correspondence via optimal assignment.

Counterpart of ``bodyfitting_tpu/utils/correspondence.py`` (host numpy
and scipy): Hungarian matching between a fitted mesh and an
equal-cardinality scan, and the reordering that aligns their vertex
indices.
"""

from __future__ import annotations

import numpy as np


def match_vertices(
    src_verts: np.ndarray, dst_verts: np.ndarray
) -> np.ndarray:
    """Indices ``perm`` minimising total ||src - dst[perm]|| (Hungarian).

    Requires equal vertex counts (e.g. a 6890-vertex scan matched
    to SMPL).  Returns ``perm`` with ``dst_verts[perm[i]]`` matched to
    ``src_verts[i]``.
    """
    from scipy.optimize import linear_sum_assignment

    src = np.asarray(src_verts, np.float64)
    dst = np.asarray(dst_verts, np.float64)
    assert src.shape == dst.shape, (src.shape, dst.shape)
    # cdist: the broadcast form materialised an (N, N, 3) f64 temp
    # (~1.1 GB at 6890 verts) for the same matrix
    from scipy.spatial.distance import cdist

    d2 = cdist(src, dst, "sqeuclidean")
    row, col = linear_sum_assignment(d2)
    perm = np.empty(len(src), np.int64)
    perm[row] = col
    return perm


def reorder_mesh(verts: np.ndarray, faces: np.ndarray,
                 perm: np.ndarray):
    """Apply a vertex permutation so ``new_verts[i] = verts[perm[i]]``,
    remapping faces accordingly."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return np.asarray(verts)[perm], inv[np.asarray(faces)]
