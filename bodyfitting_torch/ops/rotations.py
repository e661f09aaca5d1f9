"""Axis-angle to rotation matrix, batched over leading dimensions.

Counterpart of ``bodyfitting_tpu/ops/rotations.py``: the same quaternion
route, so tiny-angle values and gradients at zero match.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def rodrigues(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle ``[..., 3]`` to rotation matrices ``[..., 3, 3]``.

    Safe at ``theta = 0`` including the gradient: the norm is taken of
    ``aa + eps``, never of an exact zero vector.
    """
    angle = torch.linalg.norm(aa + _EPS, dim=-1, keepdim=True)
    half = angle * 0.5
    axis = aa / angle
    quat = torch.cat([torch.cos(half), torch.sin(half) * axis], dim=-1)
    return quat_to_rotmat(quat)


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """Quaternions ``[..., 4]`` (w, x, y, z) to ``[..., 3, 3]``; the
    quaternion is normalised first."""
    quat = quat / torch.linalg.norm(quat, dim=-1, keepdim=True).clamp(
        min=_EPS
    )
    w, x, y, z = quat.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(quat.shape[:-1] + (3, 3))
