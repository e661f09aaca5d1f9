"""Scan-fitting losses: point-to-surface, normal agreement, smoothness.

Counterpart of ``bodyfitting_tpu/losses/mesh.py`` (the reference's
scan losses and its differentiable vertex normals), with the nearest
point on the scan from :mod:`bodyfitting_torch.ops.nearest`.
``chamfer_loss`` has no caller on the ported path and waits.
"""

from __future__ import annotations

import torch

from bodyfitting_torch.ops.nearest import nearest_points


def _unit(x: torch.Tensor) -> torch.Tensor:
    """``x / (|x| + 1e-8)`` with the norm's subgradient 0 at ``x = 0``.
    The double ``where`` keeps the square root away from 0, so a
    degenerate (zero-area) face gives a finite gradient, not NaN."""
    n2 = (x * x).sum(-1, keepdim=True)
    pos = n2 > 0
    n = torch.where(pos, torch.sqrt(torch.where(pos, n2, 1.0)), 0.0)
    return x / (n + 1e-8)


def compute_vertex_normals(verts: torch.Tensor,
                           faces: torch.Tensor) -> torch.Tensor:
    """Uniform-weighted unit vertex normals ``[V, 3]`` (differentiable):
    face normals are unit-normalised first, summed onto their three
    corners, and normalised again, so every incident face votes with
    equal weight.

    The sum is ``index_add``: sequential on the CPU, atomic (so not
    bitwise repeatable) on a CUDA device."""
    faces = faces.long()
    tris = verts[faces]                                    # [F, 3, 3]
    fn = _unit(torch.linalg.cross(tris[:, 1] - tris[:, 0],
                                  tris[:, 2] - tris[:, 0], dim=-1))
    vn = torch.zeros_like(verts)
    for k in range(3):
        vn = vn.index_add(0, faces[:, k], fn)
    return _unit(vn)


def compute_face_normals(verts: torch.Tensor,
                         faces: torch.Tensor) -> torch.Tensor:
    """Unnormalised face cross products ``[F, 3]`` (the reference passes
    them raw to the normal loss)."""
    tris = verts[faces.long()]
    return torch.linalg.cross(tris[:, 1] - tris[:, 0],
                              tris[:, 2] - tris[:, 0], dim=-1)


def point_cloud_loss(points: torch.Tensor, scan_verts: torch.Tensor,
                     scan_faces: torch.Tensor, nearest=None) -> torch.Tensor:
    """Point-to-mesh term: one Frobenius norm of the stacked residuals to
    the closest scan points (the reference's ``torch.norm`` over the whole
    residual).  ``nearest`` is an optional precomputed
    :func:`nearest_points` result, shared between terms."""
    if nearest is None:
        nearest = nearest_points(points.reshape(-1, 3), scan_verts,
                                 scan_faces)
    closest, _ = nearest
    diff = points.reshape(-1, 3) - closest
    return torch.sqrt((diff * diff).sum() + 1e-20)


def normal_loss(points: torch.Tensor, point_normals: torch.Tensor,
                scan_verts: torch.Tensor, scan_faces: torch.Tensor,
                scan_face_normals: torch.Tensor, nearest=None) -> torch.Tensor:
    """``mean(1 - <closest scan face normal, point normal>)``."""
    if nearest is None:
        nearest = nearest_points(points.reshape(-1, 3), scan_verts,
                                 scan_faces)
    _, face_idx = nearest
    closest_fn = scan_face_normals[face_idx.long()]
    return (1.0 - (closest_fn * point_normals.reshape(-1, 3)).sum(-1)).mean()


def normal_laplacian_smoothness(normals: torch.Tensor,
                                faces: torch.Tensor) -> torch.Tensor:
    """Mean squared difference of the normals along each triangle's three
    edges."""
    faces = faces.long()
    na, nb, nc = (normals[faces[:, k]] for k in range(3))

    def mse(x, y):
        return ((x - y) ** 2).sum(-1)

    return (mse(na, nb) + mse(nc, na) + mse(nb, nc)).mean()
