"""Multi-view 2D keypoint reprojection losses, batched over frames and views.

Counterpart of ``bodyfitting_tpu/losses/keypoints.py``.  Keypoints are
``[B, Vw, K, 3]`` (u, v, confidence); padding views and joints carry
confidence 0.
"""

from __future__ import annotations

import numpy as np
import torch

from bodyfitting_torch.constants import NUM_BODY_KP, NUM_HAND_KP
from bodyfitting_torch.ops.camera import perspective_projection
from bodyfitting_torch.ops import comm

# knee/elbow angle prior: body-pose indices and signs
_ANGLE_PRIOR_IDXS = [55 - 3, 58 - 3, 12 - 3, 15 - 3]
_ANGLE_PRIOR_SIGNS = np.array([1.0, -1.0, -1.0, -1.0])


def gmof(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Geman-McClure robustifier."""
    x2 = x * x
    s2 = sigma * sigma
    return (s2 * x2) / (s2 + x2)


def reprojection_loss(cord, cord_gt, conf, scale_coeff: float,
                      sigma: float) -> torch.Tensor:
    """``sum_k conf_k^2 * sum_xy gmof((gt - pred) / scale)`` over the
    joint axis; ``cord``/``cord_gt`` are ``[..., K, 2]``."""
    err = gmof((cord_gt - cord) / scale_coeff, sigma).sum(dim=-1)
    return (conf * conf * err).sum(dim=-1)


def angle_prior(body_pose: torch.Tensor) -> torch.Tensor:
    """Exponential penalty on unnatural knee/elbow bending ``[..., 4]``."""
    signs = torch.as_tensor(_ANGLE_PRIOR_SIGNS, dtype=body_pose.dtype,
                            device=body_pose.device)
    sel = body_pose[..., _ANGLE_PRIOR_IDXS] * signs
    return torch.exp(sel) ** 2


def _view_terms(w2cs, Ks, keypoints, model_joints, scale_coeff, sigma,
                use_hand_face):
    """Per-view (body, hands, face) reprojection terms ``[B, Vb]``."""
    proj = perspective_projection(
        model_joints[:, None], w2cs[..., :3, :3], w2cs[..., :3, 3], Ks
    )                                                     # [B, Vb, J, 2]
    gt, conf = keypoints[..., :2], keypoints[..., 2]
    nb, nh = NUM_BODY_KP, NUM_HAND_KP

    def term(lo, hi):
        return reprojection_loss(proj[..., lo:hi, :], gt[..., lo:hi, :],
                                 conf[..., lo:hi], scale_coeff, sigma)

    body = term(0, nb)
    if not use_hand_face:
        return body, None, None
    hands = term(nb, nb + nh) + term(nb + nh, nb + 2 * nh)
    face = term(nb + 2 * nh, proj.shape[-2])
    return body, hands, face


def multiview_keypoint_loss(
    w2cs: torch.Tensor,
    Ks: torch.Tensor,
    keypoints: torch.Tensor,
    view_mask: torch.Tensor,
    model_joints: torch.Tensor,
    body_pose69: torch.Tensor,
    betas: torch.Tensor,
    pose_prior_fn,
    *,
    imsize: float = 512.0,
    sigma: float = 100.0,
    pose_prior_weight: float = 4.78,
    angle_prior_weight: float = 15.2,
    shape_prior_weight: float = 5.0,
    use_hand_face: bool = False,
    num_views_used=None,
    view_chunk: int = 0,
    view_group=None,
):
    """Total multi-view keypoint objective per frame.

    Args:
      w2cs ``[B, Vw, 4, 4]``, Ks ``[B, Vw, 3, 3]``, keypoints
      ``[B, Vw, K, 3]``, view_mask ``[B, Vw]``, model_joints ``[B, J, 3]``,
      body_pose69 ``[B, 69]``, betas ``[B, S]``.
      num_views_used: ``[B]`` denominator of the per-view sums (views with
        images); defaults to the padded view count.
      view_chunk: when > 0 and a divisor of ``Vw``, the per-view terms are
        summed over blocks of this many views (the same objective,
        re-associated), capping the ``[B, Vw, K, 2]`` transient.
      view_group: a process group over which the views are split, each
        rank holding ``Vw`` of them: the per-view sums are summed over
        it (:func:`~bodyfitting_torch.parallel.comm.sum_over`), and the
        joints enter the rank's views through
        :func:`~bodyfitting_torch.parallel.comm.copy_to`, so the
        gradient counts each view once on every rank.

    Returns ``(loss [B], dict of per-frame terms)``.
    """
    scale_coeff = imsize / 1024.0
    Vw = w2cs.shape[1]
    num_views = (num_views_used if num_views_used is not None
                 else float(Vw * comm.group_size(view_group)))
    model_joints = comm.copy_to(model_joints, view_group)

    if view_chunk and 0 < view_chunk < Vw and Vw % view_chunk == 0:
        blocks = [slice(i, i + view_chunk) for i in range(0, Vw, view_chunk)]
    else:
        blocks = [slice(0, Vw)]
    sums = None
    for blk in blocks:
        terms = _view_terms(w2cs[:, blk], Ks[:, blk], keypoints[:, blk],
                            model_joints, scale_coeff, sigma, use_hand_face)
        vm = view_mask[:, blk]
        part = [None if t is None else torch.sum(t * vm, dim=1)
                for t in terms]
        sums = part if sums is None else [
            None if a is None else a + b for a, b in zip(sums, part)
        ]
    if comm.group_size(view_group) > 1:
        n = sum(t is not None for t in sums)
        sums = list(comm.sum_over(torch.stack(sums[:n]), view_group)) \
            + [None] * (3 - n)
    body_loss = sums[0] / num_views
    zero = torch.zeros_like(body_loss)
    hand_loss = sums[1] / num_views if use_hand_face else zero
    face_loss = sums[2] / num_views if use_hand_face else zero
    loss_2d = body_loss
    if use_hand_face:
        loss_2d = loss_2d + hand_loss + face_loss

    pose_prior_loss = (pose_prior_weight ** 2) * pose_prior_fn(body_pose69)
    angle_prior_loss = (angle_prior_weight ** 2) * angle_prior(
        body_pose69
    ).sum(dim=-1)
    shape_prior_loss = (shape_prior_weight ** 2) * torch.sum(betas ** 2, -1)

    total = loss_2d + pose_prior_loss + angle_prior_loss + shape_prior_loss
    terms = {
        "reprojection_loss": loss_2d,
        "body_loss": body_loss,
        "hand_loss": hand_loss,
        "face_loss": face_loss,
        "pose_prior_loss": pose_prior_loss,
        "angle_prior_loss": angle_prior_loss,
        "shape_prior_loss": shape_prior_loss,
    }
    return total, terms
