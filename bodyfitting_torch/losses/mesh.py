"""Scan-fitting losses: point-to-surface, normal agreement, smoothness.

Counterpart of ``bodyfitting_tpu/losses/mesh.py`` (the reference's
scan losses and its differentiable vertex normals), with the nearest
point on the scan from :mod:`bodyfitting_torch.ops.nearest`, and the
subsampled chamfer distance.
"""

from __future__ import annotations

import torch

from bodyfitting_torch.ops.gather import (
    cached_row_index,
    gather_rows,
    scatter_rows,
)
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

    Each vertex sums its faces in the JAX function's order (corner by
    corner, ascending faces), and the corner gather's backward sums in
    ascending (face, corner) order (:mod:`ops.gather`; the indices built
    once per ``faces`` tensor): no atomics, so a CUDA device gives the
    same bits on every call."""
    F = faces.shape[0]
    V = verts.shape[0]
    tris = gather_rows(verts, cached_row_index(faces, V)).reshape(F, 3, 3)
    fn = _unit(torch.linalg.cross(tris[:, 1] - tris[:, 0],
                                  tris[:, 2] - tris[:, 0], dim=-1))
    corners = fn[None].expand(3, F, 3).reshape(3 * F, 3)
    return _unit(scatter_rows(corners,
                              cached_row_index(faces, V, transpose=True)))


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
    edges (the corner gather's backward in a fixed order, as in
    :func:`compute_vertex_normals`)."""
    F = faces.shape[0]
    tri = gather_rows(normals, cached_row_index(faces, normals.shape[0]))
    tri = tri.reshape(F, 3, 3)
    na, nb, nc = tri[:, 0], tri[:, 1], tri[:, 2]

    def mse(x, y):
        return ((x - y) ** 2).sum(-1)

    return (mse(na, nb) + mse(nc, na) + mse(nb, nc)).mean()


def chamfer_from_samples(src: torch.Tensor, tar: torch.Tensor) -> torch.Tensor:
    """Symmetric chamfer distance of two sampled clouds ``[S, 3]``: the
    mean over samples of the squared distance to the other cloud's nearest
    sample, both ways."""
    d2 = ((src[:, None] - tar[None]) ** 2).sum(-1)
    return (d2.min(dim=0).values + d2.min(dim=1).values).mean()


def chamfer_sample_indices(n_src: int, n_tar: int, samples: int = 500,
                           generator: torch.Generator = None, device=None):
    """The sample indices of :func:`chamfer_loss`, each cloud drawn from
    its own length (the JAX package's fix of the reference, which drew
    the target's from the source's length), uniformly with replacement
    from ``generator``."""
    si = torch.randint(0, n_src, (samples,), generator=generator,
                       device=device)
    ti = torch.randint(0, n_tar, (samples,), generator=generator,
                       device=device)
    return si, ti


def chamfer_loss(pts_src: torch.Tensor, pts_tar: torch.Tensor,
                 generator: torch.Generator = None,
                 samples: int = 500) -> torch.Tensor:
    """Subsampled symmetric chamfer distance: ``samples`` points of each
    cloud (``[..., 3]``, flattened) drawn by
    :func:`chamfer_sample_indices` from ``generator`` (it lives on the
    clouds' device), then :func:`chamfer_from_samples`.  The draws cannot
    reproduce ``jax.random``; given the same indices the value and its
    gradient are the JAX function's."""
    src = pts_src.reshape(-1, 3)
    tar = pts_tar.reshape(-1, 3)
    si, ti = chamfer_sample_indices(src.shape[0], tar.shape[0], samples,
                                    generator, device=src.device)
    return chamfer_from_samples(src[si], tar[ti])
