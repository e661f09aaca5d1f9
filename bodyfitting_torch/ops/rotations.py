"""Rotation conversions, batched over leading dimensions.

Counterpart of ``bodyfitting_tpu/ops/rotations.py``: axis-angle to matrix
by the same quaternion route, so tiny-angle values and gradients at zero
match; the HMR head's 6D decoding and its inverse; matrix to quaternion
and axis-angle by the same branchless pivot, on tensors and on the host.
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


def rotmat_to_rot6d(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrices ``[..., 3, 3]`` to the 6D representation
    ``[..., 6]``: the first two columns, row by row."""
    return m[..., :, :2].reshape(m.shape[:-2] + (6,))


def rotmat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrices ``[..., 3, 3]`` to unit quaternions ``[..., 4]``
    (w, x, y, z), branchless: the four Shepperd candidates, each a
    positive multiple of the quaternion when its pivot is the largest,
    chosen per element by the pivot tests ``tr > 0``, then the largest
    diagonal entry; normalised with the norm clipped at ``_EPS``; the sign
    canonicalised to ``w >= 0``."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    q0 = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    q1 = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10,
                      m02 + m20], dim=-1)
    q2 = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22,
                      m12 + m21], dim=-1)
    q3 = torch.stack([m10 - m01, m02 + m20, m12 + m21,
                      1.0 - m00 - m11 + m22], dim=-1)
    cond_tr = (tr > 0.0)[..., None]
    cond_0 = ((m00 > m11) & (m00 > m22))[..., None]
    cond_1 = (m11 > m22)[..., None]
    q = torch.where(cond_tr, q0,
                    torch.where(cond_0, q1, torch.where(cond_1, q2, q3)))
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(min=_EPS)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quat_to_aa(quat: torch.Tensor) -> torch.Tensor:
    """Unit quaternions ``[..., 4]`` (w, x, y, z) to axis-angle
    ``[..., 3]``: ``2 atan2(|xyz|, w)`` along ``xyz``; below ``_EPS`` the
    safe divide gives the first-order ``2 xyz``."""
    w = torch.clamp(quat[..., 0], -1.0, 1.0)
    xyz = quat[..., 1:]
    sin_half = torch.linalg.norm(xyz, dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(sin_half[..., 0], w)[..., None]
    scale = torch.where(sin_half > _EPS,
                        angle / sin_half.clamp(min=_EPS),
                        torch.full_like(sin_half, 2.0))
    return xyz * scale


def rotmat_to_aa(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrices ``[..., 3, 3]`` to axis-angle ``[..., 3]``,
    finite everywhere (:func:`rotmat_to_quat` then :func:`quat_to_aa`)."""
    return quat_to_aa(rotmat_to_quat(m))


def rodrigues_np(aa):
    """Axis-angle ``[3]`` to a rotation matrix ``[3, 3]`` in numpy float64,
    as ``cv2.Rodrigues`` computes it (host code, where the JAX package
    calls OpenCV): ``cos t I + (1 - cos t) k k^T + sin t [k]_x``, the
    identity below ``t = DBL_EPSILON``."""
    import numpy as np

    r = np.asarray(aa, np.float64).reshape(3)
    theta = float(np.linalg.norm(r))
    if theta < np.finfo(np.float64).eps:
        return np.eye(3)
    k = r / theta
    kx = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]],
                   [-k[1], k[0], 0.0]])
    c, s = np.cos(theta), np.sin(theta)
    return c * np.eye(3) + (1.0 - c) * np.outer(k, k) + s * kx


def rotmat_to_aa_f64_np(R):
    """A rotation matrix ``[3, 3]`` to axis-angle ``[3]`` in numpy float64,
    as ``cv2.Rodrigues`` computes it: ``R`` orthonormalised by its SVD,
    the angle ``acos((tr - 1) / 2)`` along the skew part, and where the
    skew part vanishes (``t`` near 0 or pi) the axis from the diagonal
    with OpenCV's sign rules."""
    import numpy as np

    u, _, vt = np.linalg.svd(np.asarray(R, np.float64).reshape(3, 3))
    R = u @ vt
    r = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    s = np.sqrt((r @ r) * 0.25)
    c = min(max((np.trace(R) - 1.0) * 0.5, -1.0), 1.0)
    theta = np.arccos(c)
    if s >= 1e-5:
        return r * (1.0 / (2.0 * s) * theta)
    if c > 0:
        return np.zeros(3)
    rx = np.sqrt(max((R[0, 0] + 1.0) * 0.5, 0.0))
    ry = np.sqrt(max((R[1, 1] + 1.0) * 0.5, 0.0)) * (-1.0 if R[0, 1] < 0
                                                     else 1.0)
    rz = np.sqrt(max((R[2, 2] + 1.0) * 0.5, 0.0)) * (-1.0 if R[0, 2] < 0
                                                     else 1.0)
    if abs(rx) < abs(ry) and abs(rx) < abs(rz) and (R[1, 2] > 0) != (
            ry * rz > 0):
        rz = -rz
    r = np.array([rx, ry, rz])
    return r * (theta / np.linalg.norm(r))


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
