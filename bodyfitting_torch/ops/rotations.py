"""Rotation conversions, batched over leading dimensions.

Counterpart of ``bodyfitting_tpu/ops/rotations.py``: axis-angle to matrix
by the same quaternion route, so tiny-angle values and gradients at zero
match; the HMR head's 6D decoding; matrix to axis-angle on the host.
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


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """The continuous 6D rotation representation ``[..., 6]`` (the first
    two columns, read as ``reshape(3, 2)``) to ``[..., 3, 3]`` by
    Gram-Schmidt, as the HMR head decodes its pose."""
    x = x.reshape(x.shape[:-1] + (3, 2))
    a1, a2 = x[..., 0], x[..., 1]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True).clamp(min=_EPS)
    b2 = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = b2 / torch.linalg.norm(b2, dim=-1, keepdim=True).clamp(min=_EPS)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


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


def rotmat_to_aa_np(m):
    """Rotation matrices ``[..., 3, 3]`` to axis-angle ``[..., 3]`` in
    numpy float32: the JAX package's ``rotmat_to_aa_np``, formula for
    formula (quaternion with the trace/diagonal pivot, sign canonicalised
    to ``w >= 0``, then ``2 atan2(|xyz|, w)``).  Host-side set-up code
    (the mean-pose init) uses it."""
    import numpy as np

    m = np.asarray(m, np.float32)
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    q0 = np.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    q1 = np.stack(
        [m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], axis=-1
    )
    q2 = np.stack(
        [m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], axis=-1
    )
    q3 = np.stack(
        [m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], axis=-1
    )
    cond_tr = (tr > 0.0)[..., None]
    cond_0 = ((m00 > m11) & (m00 > m22))[..., None]
    cond_1 = (m11 > m22)[..., None]
    q = np.where(cond_tr, q0, np.where(cond_0, q1, np.where(cond_1, q2, q3)))
    q = (q / np.clip(np.linalg.norm(q, axis=-1, keepdims=True), _EPS, None)
         ).astype(np.float32)
    q = q * np.where(q[..., :1] < 0, -1.0, 1.0).astype(np.float32)
    w = np.clip(q[..., 0], -1.0, 1.0)
    xyz = q[..., 1:]
    sin_half = np.linalg.norm(xyz, axis=-1, keepdims=True).astype(np.float32)
    angle = (2.0 * np.arctan2(sin_half[..., 0], w))[..., None]
    scale = np.where(
        sin_half > _EPS, angle / np.clip(sin_half, _EPS, None), 2.0
    ).astype(np.float32)
    return (xyz * scale).astype(np.float32)
