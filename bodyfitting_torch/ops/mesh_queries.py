"""Mesh membership and ray queries: inside-mesh and intersects-any.

Counterpart of ``bodyfitting_tpu/ops/mesh_queries.py`` (XLA there, no
kernel): Moller-Trumbore ray/triangle tests of every query against every
face, over chunks of faces so memory stays ``O(Q x block)``; the crossing
counts (inside-mesh) or hits (intersects-any) accumulate over chunks.
"""

from __future__ import annotations

import torch

_EPS = 1e-9

# The jittered +x direction inside_mesh casts along (off the axes, so a
# ray rarely grazes an edge or a vertex of an axis-aligned mesh).
INSIDE_RAY = (0.9827371, 0.1356791, 0.1259371)


def _moller_trumbore(orig, direc, a, b, c):
    """Ray/triangle hit test, broadcastable: ``orig``/``direc`` and the
    corners ``a``/``b``/``c`` ``[..., 3]``.  Returns ``(hit, t)``, ``t``
    the ray parameter (inf where missed); a hit needs ``|det| > _EPS``
    and ``t > _EPS``."""
    e1 = b - a
    e2 = c - a
    pvec = torch.linalg.cross(*torch.broadcast_tensors(direc, e2), dim=-1)
    det = (e1 * pvec).sum(-1)
    ok = det.abs() > _EPS
    inv_det = torch.where(ok, 1.0 / det, torch.zeros_like(det))
    tvec = orig - a
    u = (tvec * pvec).sum(-1) * inv_det
    qvec = torch.linalg.cross(*torch.broadcast_tensors(tvec, e1), dim=-1)
    v = (direc * qvec).sum(-1) * inv_det
    t = (e2 * qvec).sum(-1) * inv_det
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > _EPS)
    return hit, torch.where(hit, t, torch.full_like(t, float("inf")))


def _face_block(n_queries: int, n_faces: int, face_block, device) -> int:
    """The faces a chunk tests: ``face_block`` when given, else about
    2^24 query-face pairs a chunk on a CUDA device and 2^20 elsewhere."""
    if face_block is not None:
        return int(face_block)
    pairs = (1 << 24) if torch.device(device).type == "cuda" else (1 << 20)
    return max(1, min(n_faces, pairs // max(n_queries, 1)))


def _chunks(verts, faces, block):
    tri = verts[faces.long()]                              # [F, 3, 3]
    for s in range(0, tri.shape[0], block):
        t = tri[s:s + block]
        yield t[None, :, 0], t[None, :, 1], t[None, :, 2]


@torch.no_grad()
def intersects_any(origins: torch.Tensor, directions: torch.Tensor,
                   verts: torch.Tensor, faces: torch.Tensor,
                   face_block=None) -> torch.Tensor:
    """Whether each ray (``origins``, ``directions`` ``[R, 3]``) hits the
    mesh anywhere: ``[R]`` bool."""
    block = _face_block(origins.shape[0], faces.shape[0], face_block,
                        origins.device)
    out = torch.zeros(origins.shape[0], dtype=torch.bool,
                      device=origins.device)
    o, d = origins[:, None], directions[:, None]
    for a, b, c in _chunks(verts, faces, block):
        hit, _ = _moller_trumbore(o, d, a, b, c)
        out |= hit.any(dim=1)
    return out


@torch.no_grad()
def inside_mesh(points: torch.Tensor, verts: torch.Tensor,
                faces: torch.Tensor, face_block=None) -> torch.Tensor:
    """Ray-cast parity containment of ``points [Q, 3]`` in a closed mesh:
    ``[Q]`` bool, True where a ray along :data:`INSIDE_RAY` crosses the
    surface an odd number of times."""
    block = _face_block(points.shape[0], faces.shape[0], face_block,
                        points.device)
    d = torch.tensor(INSIDE_RAY, dtype=points.dtype,
                     device=points.device)[None, None]
    count = torch.zeros(points.shape[0], dtype=torch.int32,
                        device=points.device)
    p = points[:, None]
    for a, b, c in _chunks(verts, faces, block):
        hit, _ = _moller_trumbore(p, d, a, b, c)
        count += hit.sum(dim=1, dtype=torch.int32)
    return (count % 2) == 1
