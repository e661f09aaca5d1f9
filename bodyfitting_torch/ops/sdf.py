"""Precomputed distance volumes for point-to-scan queries.

Counterpart of ``bodyfitting_tpu/ops/sdf.py``.  The scan is static for
the whole fit, so its unsigned distance and nearest face are computed
once per scan on a padded uniform grid (:func:`build_distance_volume`,
through the nearest-point kernel on the card), and each fitting step
reads them with O(Q) lookups.

:func:`query_distance` is the 8-tap trilinear gather plus the
out-of-volume term.  The JAX package evaluates the same function as a
one-hot hinge matmul, which suits the TPU's matrix unit, and keeps the
gather (``_query_distance_gather``) as its oracle; no kernel is
involved, so the gather is the port.
"""

from __future__ import annotations

import dataclasses

import torch

from bodyfitting_torch.ops.kernels.nearest import nearest_d2_idx


@dataclasses.dataclass(frozen=True)
class DistanceVolume:
    dist: torch.Tensor        # [R, R, R] unsigned distances
    face_idx: torch.Tensor    # [R, R, R] int32 nearest face per cell centre
    origin: torch.Tensor      # [3] world position of cell (0, 0, 0)
    spacing: torch.Tensor     # scalar cell size

    @property
    def resolution(self) -> int:
        return self.dist.shape[-1]


@torch.no_grad()
def build_distance_volume(verts: torch.Tensor, faces: torch.Tensor,
                          resolution: int = 96, padding: float = 0.15,
                          point_chunk: int = 65536) -> DistanceVolume:
    """One exact nearest-point sweep over all grid cell centres, in chunks
    of ``point_chunk`` cells (14 chunks at 96³).

    The grid spans the mesh's bounding box grown by ``padding`` of its
    largest extent on every side, with cubic cells.  Each cell holds the
    distance to the mesh and the face the tie rule picks
    (``ops.nearest``); the JAX package's CPU route picks the same face.
    """
    vmin = verts.min(dim=0).values
    vmax = verts.max(dim=0).values
    extent = torch.max(vmax - vmin)
    pad = extent * padding
    lo = vmin - pad
    hi = vmax + pad
    spacing = torch.max(hi - lo) / (resolution - 1)
    r = torch.arange(resolution, dtype=verts.dtype, device=verts.device)
    axes = [lo[i] + spacing * r for i in range(3)]
    grid = torch.stack(torch.meshgrid(*axes, indexing="ij"),
                       dim=-1).reshape(-1, 3)
    tri = verts[faces.long()].contiguous()
    tie_verts = verts.contiguous()
    dists, fids = [], []
    for start in range(0, grid.shape[0], point_chunk):
        d2, fid = nearest_d2_idx(grid[start:start + point_chunk].contiguous(),
                                 tri, tie_verts=tie_verts)
        dists.append(torch.sqrt(d2))
        fids.append(fid)
    R = resolution
    return DistanceVolume(
        dist=torch.cat(dists).reshape(R, R, R),
        face_idx=torch.cat(fids).reshape(R, R, R),
        origin=lo,
        spacing=spacing,
    )


def _grid_coords(volume: DistanceVolume, points: torch.Tensor):
    """Clamped grid coordinates and the out-of-volume distance (world
    units; zero with zero gradient inside)."""
    R = volume.resolution
    g_raw = (points - volume.origin) / volume.spacing
    g = torch.clamp(g_raw, 0.0, R - 1 - 1e-5)
    outside = torch.sqrt(((g_raw - g) ** 2).sum(-1) + 1e-20) * volume.spacing
    return g, outside


def query_distance(volume: DistanceVolume,
                   points: torch.Tensor) -> torch.Tensor:
    """Trilinear unsigned distance at ``points [Q, 3]`` (differentiable in
    ``points``), plus the distance from each point to the volume when it
    lies outside, so values keep growing and gradients keep pointing
    inward arbitrarily far out."""
    R = volume.resolution
    g, outside = _grid_coords(volume, points)
    g0 = torch.floor(g)
    w = g - g0
    i0 = g0.long()
    ix, iy, iz = i0[:, 0], i0[:, 1], i0[:, 2]
    dist = volume.dist

    def tap(dx, dy, dz):
        # Python-int offsets: no host-to-device copy in the step
        return dist[torch.clamp(ix + dx, max=R - 1),
                    torch.clamp(iy + dy, max=R - 1),
                    torch.clamp(iz + dz, max=R - 1)]

    wx, wy, wz = w[:, 0], w[:, 1], w[:, 2]
    return (
        tap(0, 0, 0) * (1 - wx) * (1 - wy) * (1 - wz)
        + tap(1, 0, 0) * wx * (1 - wy) * (1 - wz)
        + tap(0, 1, 0) * (1 - wx) * wy * (1 - wz)
        + tap(0, 0, 1) * (1 - wx) * (1 - wy) * wz
        + tap(1, 1, 0) * wx * wy * (1 - wz)
        + tap(1, 0, 1) * wx * (1 - wy) * wz
        + tap(0, 1, 1) * (1 - wx) * wy * wz
        + tap(1, 1, 1) * wx * wy * wz
    ) + outside


@torch.no_grad()
def query_nearest_face(volume: DistanceVolume,
                       points: torch.Tensor) -> torch.Tensor:
    """Nearest-face index of the cell nearest each point ``[Q, 3]``
    (coordinates rounded half to even, as ``jnp.round``; clamped to the
    grid)."""
    R = volume.resolution
    g = (points - volume.origin) / volume.spacing
    i = torch.clamp(torch.round(g), 0, R - 1).long()
    return volume.face_idx[i[:, 0], i[:, 1], i[:, 2]]


def point_cloud_loss_sdf(points: torch.Tensor,
                         volume: DistanceVolume) -> torch.Tensor:
    """Point-to-surface term through the volume: one L2 norm of the
    stacked distances, ``sqrt(sum_i d_i^2)`` (the reference's Frobenius
    norm)."""
    d = query_distance(volume, points.reshape(-1, 3))
    return torch.sqrt((d * d).sum() + 1e-20)


def normal_loss_sdf(points: torch.Tensor, point_normals: torch.Tensor,
                    volume: DistanceVolume,
                    scan_face_normals: torch.Tensor) -> torch.Tensor:
    """``mean(1 - <nearest scan face normal, point normal>)`` with the
    nearest face read from the volume."""
    fid = query_nearest_face(volume, points.reshape(-1, 3))
    closest_fn = scan_face_normals[fid.long()]
    return (1.0 - (closest_fn * point_normals.reshape(-1, 3)).sum(-1)).mean()
