"""Frame-level fitting entry points.

Counterpart of ``bodyfitting_tpu/fitting/body_fitting.py``
(``build_observations`` and ``fit_frames_batched``): host-side data of one
frame becomes an :class:`~bodyfitting_torch.fitting.smplify.Observations`
with a frame axis of 1, and a batch of frames is fitted in one staged
optimization.  HMR initialisation and scan fitting wait for later slices.
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
    """
    if scan_verts is not None or scan_faces is not None:
        raise NotImplementedError("scan fitting waits for a later slice "
                                  "of the port")
    device = default_device(device)

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
