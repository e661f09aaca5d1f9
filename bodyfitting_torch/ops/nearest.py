"""Nearest point-on-mesh queries.

Counterpart of ``bodyfitting_tpu/ops/nearest.py``.  The sweep itself is
``ops.kernels.nearest_d2_idx``: the hand-written CUDA kernel for CUDA
tensors, its blocked PyTorch version for CPU tensors.  Both apply the
JAX package's tie rule (lowest face index within :func:`tie_threshold`
of the minimum), so the face index does not depend on the order in
which faces are visited.

Gradient semantics follow the reference: :func:`nearest_points` returns
constants, so a loss differentiates through the query points only.
"""

from __future__ import annotations

import torch

from bodyfitting_torch.ops.kernels.nearest import (  # noqa: F401 (re-export)
    closest_point_on_triangles,
    nearest_d2_idx,
    tie_threshold,
)


@torch.no_grad()
def nearest_point_on_mesh(points: torch.Tensor, verts: torch.Tensor,
                          faces: torch.Tensor):
    """For each query point ``[Q, 3]``, the closest point on the mesh
    ``(verts [V, 3], faces [F, 3])``.

    Returns ``(closest [Q, 3], face_idx [Q] int32, sqdist [Q])``: the
    sweep's minimum and tie-broken face, then the closest point recomputed
    on that face, as the JAX function's ``tie_break=True`` route does.
    Not differentiable (see :func:`nearest_points`).
    """
    tri = verts[faces.long()]                               # [F, 3, 3]
    d2, idx = nearest_d2_idx(points.contiguous(), tri.contiguous(),
                             tie_verts=verts.contiguous())
    t = tri[idx.long()]                                     # [Q, 3, 3]
    pt = closest_point_on_triangles(points, t[:, 0], t[:, 1], t[:, 2])
    return pt, idx, d2


def nearest_points(points: torch.Tensor, verts: torch.Tensor,
                   faces: torch.Tensor):
    """``(closest [Q, 3], face_idx [Q])`` as constants: the query runs on
    detached inputs under ``no_grad``, the reference's disabled backward,
    so gradients flow only through the caller's own use of ``points``."""
    pt, idx, _ = nearest_point_on_mesh(points.detach(), verts.detach(), faces)
    return pt, idx
