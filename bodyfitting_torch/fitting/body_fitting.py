"""Frame-level fitting entry points.

Counterpart of ``bodyfitting_tpu/fitting/body_fitting.py``: host-side
data of one frame becomes an
:class:`~bodyfitting_torch.fitting.smplify.Observations` with a frame axis
of 1 (``build_observations``, with the scan and its distance volume for
scan fits); a batch of frames is fitted in one staged optimization
(``fit_frames_batched``), and one scan by ``fit_scan``.  ``hmr_init``
gives the mean-pose initialisation; the HMR network waits for a later
slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from bodyfitting_torch import constants
from bodyfitting_torch.device import default_device
from bodyfitting_torch.fitting import smplify
from bodyfitting_torch.io.openpose import pack_keypoints
from bodyfitting_torch.losses.silhouette import (
    binarize_mask,
    compute_mask_crops,
    extract_contours,
    resample_contours,
)
from bodyfitting_torch.ops import sdf
from bodyfitting_torch.ops.rotations import rotmat_to_aa_np


def hmr_init(image: Optional[np.ndarray], c2w: np.ndarray, bundle=None):
    """Initial ``(betas [10], poses [72])`` (float32 numpy) for a fit: the
    mean pose, with the global orientation rotated into the world frame
    through the keyframe's camera-to-world rotation, as the JAX
    ``hmr_init`` does without a network.  The HMR network (``bundle``)
    waits for a later slice of the port and raises."""
    if bundle is not None:
        raise NotImplementedError("the HMR network waits for a later slice "
                                  "of the port; pass bundle=None")
    rotmat = np.broadcast_to(np.eye(3, dtype=np.float32), (24, 3, 3)).copy()
    rotmat[0] = np.asarray(c2w)[:3, :3] @ rotmat[0]
    poses = rotmat_to_aa_np(rotmat).reshape(-1)
    return np.zeros(10, np.float32), poses.astype(np.float32)


def init_params_from_hmr(model, betas: np.ndarray,
                         poses: np.ndarray) -> smplify.FitParams:
    """``hmr_init``'s output as the initial :class:`FitParams` of one
    frame (betas cut or zero-padded to the model's count)."""
    nb = model.num_body_joints
    body_pose = poses[3:3 + 3 * nb]
    init_betas = betas
    if model.num_betas != betas.shape[0]:
        init_betas = np.zeros(model.num_betas, np.float32)
        init_betas[: min(model.num_betas, betas.shape[0])] = betas[
            : model.num_betas
        ]
    return smplify.FitParams.init(
        model, init_betas=init_betas, init_global_orient=poses[:3],
        init_body_pose=body_pose,
    )


def build_observations(
    c2ws: Sequence[np.ndarray],
    Ks: Sequence[np.ndarray],
    keypoints: Sequence[Optional[dict]],
    use_hand_face: bool,
    constant_scale: float = constants.GENEBODY_SCENE_SCALE,
    masks: Optional[Sequence[np.ndarray]] = None,
    mask_c2ws: Optional[Sequence[np.ndarray]] = None,
    mask_Ks: Optional[Sequence[np.ndarray]] = None,
    scan_verts: Optional[np.ndarray] = None,
    scan_faces: Optional[np.ndarray] = None,
    num_views: Optional[int] = None,
    mask_num_views: Optional[int] = None,
    mask_imsize: Optional[int] = None,
    contour_pad: Optional[int] = None,
    contour_resample: Optional[int] = 512,
    mask_crop: bool = False,
    mask_crop_hw: Optional[tuple] = None,
    build_sdf: bool = True,
    sdf_resolution: int = 96,
    device=None,
) -> smplify.Observations:
    """One frame's Observations (leading frame axis of 1) on ``device``
    (default ``cuda``).

    ``num_views`` / ``mask_num_views`` / ``contour_pad`` / ``mask_crop_hw``
    fix the padded shapes so frames concatenate into a batch.  Padded
    mask views are inert: all-ones masks (crop mode: zero view validity),
    zero contour validity, identity cameras.  ``contour_resample``
    arc-length resamples contours to that many points.  ``mask_crop``
    stores content crops for the stay-inside term instead of full masks.

    With ``scan_verts`` / ``scan_faces`` (a scan fit), the scan's height
    is its y extent and the constant scale ``height / 1.7``; with
    ``build_sdf`` its ``sdf_resolution``³ distance volume is built here,
    through the nearest-point kernel on the card.
    """
    device = default_device(device)
    obs = _keypoint_and_mask_observations(
        c2ws, Ks, keypoints, use_hand_face, constant_scale, masks, mask_c2ws,
        mask_Ks, num_views, mask_num_views, mask_imsize, contour_pad,
        contour_resample, mask_crop, mask_crop_hw, device)
    if scan_verts is None:
        return obs
    sv = np.asarray(scan_verts, np.float32)
    height = float(sv[:, 1].max() - sv[:, 1].min())
    verts = torch.tensor(sv, device=device)
    faces = torch.tensor(np.asarray(scan_faces, np.int64), device=device)
    obs = dataclasses.replace(
        obs, scan_verts=verts[None], scan_faces=faces[None],
        scan_height=torch.tensor([height], dtype=torch.float32,
                                 device=device),
        constant_scale=torch.tensor(
            [np.float32(height / constants.RENDERPEOPLE_PERSON_HEIGHT)],
            device=device),
    )
    if build_sdf:
        vol = sdf.build_distance_volume(verts, faces,
                                        resolution=sdf_resolution)
        obs = dataclasses.replace(obs, scan_volume=sdf.DistanceVolume(
            dist=vol.dist[None], face_idx=vol.face_idx[None],
            origin=vol.origin[None], spacing=vol.spacing.reshape(1)))
    return obs


def _keypoint_and_mask_observations(
        c2ws, Ks, keypoints, use_hand_face, constant_scale, masks, mask_c2ws,
        mask_Ks, num_views, mask_num_views, mask_imsize, contour_pad,
        contour_resample, mask_crop, mask_crop_hw, device):
    """The keypoint and mask fields of :func:`build_observations`."""

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)[None]

    c2ws = np.asarray(c2ws, np.float32)
    w2cs = np.linalg.inv(c2ws)
    kps, view_mask = pack_keypoints(
        keypoints, use_hand_face=use_hand_face, num_views=num_views
    )
    Vw = kps.shape[0]
    w2cs_p = np.zeros((Vw, 4, 4), np.float32)
    Ks_p = np.zeros((Vw, 3, 3), np.float32)
    w2cs_p[: len(w2cs)] = w2cs
    w2cs_p[len(w2cs):] = np.eye(4)
    Ks_p[: len(Ks)] = np.asarray(Ks, np.float32)
    Ks_p[len(Ks):] = np.eye(3)
    view_mask[len(w2cs):] = 0.0     # views without cameras never count

    obs = smplify.Observations(
        w2cs=t(w2cs_p), Ks=t(Ks_p), keypoints=t(kps),
        view_mask=t(view_mask), constant_scale=t(constant_scale),
        num_views_used=t(float(len(w2cs))),
    )
    if masks is None:
        return obs
    if len(masks) == 0:
        if not (mask_num_views and mask_imsize):
            return obs
        # every mask view of this frame was dropped: fully inert mask
        # observations, so the frame still batches with the others
        Vm = mask_num_views
        P = contour_pad or 512
        if contour_resample and P > contour_resample:
            P = contour_resample
        contours = np.zeros((Vm, P, 2), np.float32)
        valid = np.zeros((Vm, P), np.float32)
        mw2cs = np.broadcast_to(np.eye(4, dtype=np.float32), (Vm, 4, 4))
        mKs = np.broadcast_to(np.eye(3, dtype=np.float32), (Vm, 3, 3))
        H = int(mask_imsize)
        mask_arr = np.ones((Vm, H, H), np.float32)
        Hc, Wc = mask_crop_hw or (8, 128)
        crops = np.ones((Vm, Hc, Wc), np.float32)
        origins = np.zeros((Vm, 2), np.float32)
        vvalid = np.zeros((Vm,), np.float32)
    else:
        contours, valid = extract_contours(masks, pad_to=contour_pad)
        if contour_resample and contours.shape[1] > contour_resample:
            contours, valid = resample_contours(contours, valid,
                                                contour_resample)
        mw2cs = np.linalg.inv(np.asarray(mask_c2ws, np.float32))
        mKs = np.asarray(mask_Ks, np.float32)
        mask_arr = crops = origins = vvalid = None
        if mask_crop:
            crops, origins, (Hc, Wc) = compute_mask_crops(
                list(masks), crop_hw=mask_crop_hw
            )
            vvalid = np.ones(len(masks), np.float32)
        else:
            mask_arr = np.stack([binarize_mask(m) for m in masks])
        pad_n = (mask_num_views or len(masks)) - len(masks)
        if pad_n > 0:
            def pad(a, fill):
                return np.concatenate(
                    [a, np.full((pad_n,) + a.shape[1:], fill, np.float32)]
                )
            contours, valid = pad(contours, 0.0), pad(valid, 0.0)
            mw2cs = np.concatenate(
                [mw2cs, np.broadcast_to(np.eye(4, dtype=np.float32),
                                        (pad_n, 4, 4))])
            mKs = np.concatenate(
                [mKs, np.broadcast_to(np.eye(3, dtype=np.float32),
                                      (pad_n, 3, 3))])
            if mask_crop:
                crops, origins = pad(crops, 1.0), pad(origins, 0.0)
                vvalid = pad(vvalid, 0.0)
            else:
                mask_arr = pad(mask_arr, 1.0)
    obs = dataclasses.replace(
        obs, mask_w2cs=t(mw2cs), mask_Ks=t(mKs), contours=t(contours),
        contour_valid=t(valid),
    )
    if mask_crop:
        return dataclasses.replace(
            obs, mask_crops=t(crops), mask_crop_origins=t(origins),
            mask_view_valid=t(vvalid),
        )
    return dataclasses.replace(obs, masks=t(mask_arr))


def fit_frames_batched(
    model,
    config: smplify.FitConfig,
    obs_list: Sequence[smplify.Observations],
    init_list: Sequence[smplify.FitParams],
    pose_prior_fn,
):
    """Concatenate per-frame observations and initial parameters along the
    frame axis and fit them all at once on the model's device.

    Returns ``(FitParams, result dict, losses [B, num_iters])``.
    """
    obs = smplify.concat_frames(list(obs_list))
    init = smplify.concat_frames(list(init_list))
    return smplify.fit(model, config, obs, init, pose_prior_fn)


def fit_scan(model, config: smplify.FitConfig, obs: smplify.Observations,
             init: smplify.FitParams, pose_prior_fn):
    """Fit one scan (``obs`` and ``init`` of one frame), the counterpart
    of the JAX app's unbatched fit program (``_fit_program(...,
    batched=False)``).  Returns ``(FitParams, result, losses)`` with the
    result arrays and the loss trace (body steps, then displacement
    steps) without the frame axis; the parameters keep it."""
    params, result, losses = smplify.fit(model, config, obs, init,
                                         pose_prior_fn)
    return params, {k: v[0] for k, v in result.items()}, losses[0]
