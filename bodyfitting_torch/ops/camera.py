"""Pinhole camera ops, batched over leading dimensions.

Counterpart of ``bodyfitting_tpu/ops/camera.py``: the rigid world ->
camera transform and the projection, the closed-form inverse of a rigid
transform, intrinsics of a crop, and look-at / ring extrinsics.
"""

from __future__ import annotations

import math

import torch


def world_to_camera(points: torch.Tensor, R: torch.Tensor,
                    t: torch.Tensor) -> torch.Tensor:
    """``R x + t`` for points ``[..., N, 3]``, ``R [..., 3, 3]``,
    ``t [..., 3]``."""
    return torch.einsum("...ij,...nj->...ni", R, points) + t[..., None, :]


def perspective_projection(
    points: torch.Tensor, R: torch.Tensor, t: torch.Tensor, K: torch.Tensor
) -> torch.Tensor:
    """World points ``[..., N, 3]`` to pixels ``[..., N, 2]``:
    ``K (R x + t)`` then the perspective divide.

    The divide is deliberately unguarded (the reference's behaviour): a
    point at camera depth 0 projects to inf/nan, and callers mask such
    points by their in-image test.
    """
    cam = world_to_camera(points, R, t)
    proj = torch.einsum("...ij,...nj->...ni", K, cam)
    return proj[..., :2] / proj[..., 2:3]


def invert_rigid(T: torch.Tensor) -> torch.Tensor:
    """Rigid transforms ``[..., 4, 4]`` inverted in closed form:
    ``(R^T, -R^T t)``, exactly orthogonal."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    out = torch.zeros_like(T)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -torch.einsum("...ij,...j->...i", Rt, t)
    out[..., 3, 3] = 1.0
    return out


def _f32(x) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(torch.float32)
    return torch.as_tensor(x, dtype=torch.float32)


def adjust_intrinsics_for_crop(K, top, left, bottom, right,
                               out_size: int) -> torch.Tensor:
    """Intrinsics of the crop ``[top:bottom, left:right]`` resized to
    ``out_size`` squared, in float32 whatever came in.  The box is scalars
    or batched (``[...]``, one box per matrix)."""
    K = _f32(K).clone()
    top, left, bottom, right = (_f32(v).to(K.device)
                                for v in (top, left, bottom, right))
    # a tensor numerator: ``int / tensor`` multiplies by the reciprocal
    size = torch.tensor(float(out_size), device=K.device)
    sx = size / (right - left)
    sy = size / (bottom - top)
    K[..., 0, 2] = K[..., 0, 2] - left
    K[..., 1, 2] = K[..., 1, 2] - top
    K[..., 0, :] = K[..., 0, :] * (sx[..., None] if sx.ndim else sx)
    K[..., 1, :] = K[..., 1, :] * (sy[..., None] if sy.ndim else sy)
    return K


def look_at_extrinsics(eye: torch.Tensor, center: torch.Tensor,
                       up: torch.Tensor) -> torch.Tensor:
    """World -> camera extrinsics ``[..., 4, 4]`` of a camera at ``eye``
    looking at ``center`` (OpenCV convention: +z forward, +y down)."""
    fwd = center - eye
    fwd = fwd / torch.linalg.norm(fwd, dim=-1, keepdim=True).clamp(min=1e-8)
    right = torch.linalg.cross(fwd, up, dim=-1)
    right = right / torch.linalg.norm(right, dim=-1,
                                      keepdim=True).clamp(min=1e-8)
    down = torch.linalg.cross(fwd, right, dim=-1)
    R = torch.stack([right, down, fwd], dim=-2)           # rows
    T = R.new_zeros(R.shape[:-2] + (4, 4))
    T[..., :3, :3] = R
    T[..., :3, 3] = -torch.einsum("...ij,...j->...i", R, eye)
    T[..., 3, 3] = 1.0
    return T


def ring_cameras(num_views: int, center: torch.Tensor, radius: float,
                 height: float = 0.0,
                 up: tuple = (0.0, 1.0, 0.0)) -> torch.Tensor:
    """``[num_views, 4, 4]`` world -> camera extrinsics on a ring around
    ``center [3]``, the first camera on +z, looking at ``center``."""
    center = torch.as_tensor(center)
    angles = torch.linspace(0.0, 2.0 * math.pi, num_views + 1,
                            dtype=center.dtype,
                            device=center.device)[:num_views]
    eyes = torch.stack([
        center[0] + radius * torch.sin(angles),
        center[1] + height + torch.zeros_like(angles),
        center[2] + radius * torch.cos(angles),
    ], dim=-1)
    up_v = torch.as_tensor(up, dtype=center.dtype,
                           device=center.device).expand(eyes.shape)
    return look_at_extrinsics(eyes, center.expand(eyes.shape), up_v)
