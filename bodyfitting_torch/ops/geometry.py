"""Camera translation from keypoints, and HMR crop <-> image translations.

Counterpart of ``bodyfitting_tpu/ops/geometry.py``: the weighted
least-squares translation estimate, batched, and the transfers of a
camera translation between HMR's crop frame and the full image.
"""

from __future__ import annotations

import torch

from bodyfitting_torch.constants import FOCAL_LENGTH, IMG_RES


def estimate_translation_single(S: torch.Tensor, joints_2d: torch.Tensor,
                                joints_conf: torch.Tensor,
                                focal_length: float = FOCAL_LENGTH,
                                img_size: float = IMG_RES) -> torch.Tensor:
    """Weighted least-squares camera translation ``[3]`` of one set of
    joints ``S [K, 3]`` seen at ``joints_2d [K, 2]`` with confidences
    ``joints_conf [K]``: the linearised rows ``f tx + (c - u) tz =
    (u - c) Z - f X`` (and in y), weighted by ``sqrt(max(conf, 0))``,
    solved through the normal equations with a ``1e-8 I`` ridge."""
    K = S.shape[0]
    dt, dev = S.dtype, S.device
    Z = S[:, 2:3].repeat(1, 2).reshape(-1)                 # [2K]
    XY = S[:, :2].reshape(-1)
    O = torch.full((2 * K,), img_size / 2.0, dtype=dt, device=dev)
    F = torch.full((2 * K,), focal_length, dtype=dt, device=dev)
    x = joints_2d.reshape(-1)
    w = torch.sqrt(torch.clamp(joints_conf, min=0.0)).repeat_interleave(2)
    ex = torch.tensor([1.0, 0.0], dtype=dt, device=dev).repeat(K)
    ey = torch.tensor([0.0, 1.0], dtype=dt, device=dev).repeat(K)
    Q = torch.stack([F * ex, F * ey, O - x], dim=1)        # [2K, 3]
    c = (x - O) * Z - F * XY
    Qw = Q * w[:, None]
    cw = c * w
    A = Qw.T @ Qw
    b = Qw.T @ cw
    return torch.linalg.solve(A + 1e-8 * torch.eye(3, dtype=dt, device=dev),
                              b)


def estimate_translation(S: torch.Tensor, joints_2d_conf: torch.Tensor,
                         focal_length: float = FOCAL_LENGTH,
                         img_size: float = IMG_RES,
                         use_gt_joints_only: bool = True) -> torch.Tensor:
    """Batched :func:`estimate_translation_single`: ``S [B, J, 3]``,
    ``joints_2d_conf [B, J, 3]`` (u, v, conf) -> ``[B, 3]``.  With
    ``use_gt_joints_only`` only the SPIN joints from 25 on are used."""
    if use_gt_joints_only:
        S = S[:, 25:]
        joints_2d_conf = joints_2d_conf[:, 25:]
    return torch.stack([
        estimate_translation_single(s, j[:, :2], j[:, 2], focal_length,
                                    img_size)
        for s, j in zip(S, joints_2d_conf)])


def _crop_terms(zoom_scale, crop_center, crop_scale, K, virtual_focal):
    cx, cy, fx = K[0, 2], K[1, 2], K[0, 0]
    scale = 1.0 / virtual_focal / crop_scale / 200.0 * IMG_RES
    zero = torch.zeros((), dtype=K.dtype, device=K.device)
    one = torch.ones((), dtype=K.dtype, device=K.device)
    shift = torch.stack([(crop_center[0] - cx) * scale,
                         (crop_center[1] - cy) * scale, zero])
    return shift, torch.stack([one, one, fx * scale])


def crop_to_global_translation(cam_t: torch.Tensor, zoom_scale: float,
                               crop_center: torch.Tensor, crop_scale: float,
                               K: torch.Tensor,
                               virtual_focal: float = FOCAL_LENGTH
                               ) -> torch.Tensor:
    """An HMR crop-frame camera translation ``[3]`` in the full image's
    frame (intrinsics ``K``)."""
    shift, mul = _crop_terms(zoom_scale, crop_center, crop_scale, K,
                             virtual_focal)
    return (cam_t + shift * cam_t[2]) * mul * zoom_scale


def global_to_crop_translation(cam_t_global: torch.Tensor,
                               zoom_scale: float, crop_center: torch.Tensor,
                               crop_scale: float, K: torch.Tensor,
                               virtual_focal: float = FOCAL_LENGTH
                               ) -> torch.Tensor:
    """The inverse of :func:`crop_to_global_translation`."""
    shift, mul = _crop_terms(zoom_scale, crop_center, crop_scale, K,
                             virtual_focal)
    out = cam_t_global / mul / zoom_scale
    return out - shift * out[2]
