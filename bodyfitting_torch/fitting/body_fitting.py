"""Frame-level fitting entry points.

Counterpart of ``bodyfitting_tpu/fitting/body_fitting.py``: host-side
data of one frame becomes an
:class:`~bodyfitting_torch.fitting.smplify.Observations` with a frame axis
of 1 (``build_observations``, with the scan and its distance volume for
scan fits); the keyframe's HMR network (or the mean pose) gives the
initial parameters (``hmr_init``); a batch of frames is fitted in one
staged optimization (``fit_frames_batched``), or jointly with temporal
terms (``fit_sequence_batched``), and one scan by ``fit_scan``;
``save_frame_outputs`` writes each frame's parameters, mesh and debug
overlays.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
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


@dataclasses.dataclass
class HMRBundle:
    """A loaded HMR network and its mean parameters."""

    model: object = None
    mean_params: Optional[tuple] = None

    @staticmethod
    def load(checkpoint_path: str, mean_params_path: Optional[str] = None,
             device=None) -> "HMRBundle":
        """The network on ``device`` (default ``cuda``) with the weights of
        the torch checkpoint at ``checkpoint_path`` (the reference's own
        keys); a path that does not exist raises."""
        from bodyfitting_torch.models import hmr as hmr_mod

        device = default_device(device)
        if not os.path.exists(checkpoint_path):
            raise FileNotFoundError(f"HMR checkpoint not found: "
                                    f"{checkpoint_path}")
        sd = torch.load(checkpoint_path, map_location="cpu",
                        weights_only=False)
        net = hmr_mod.HMR()
        hmr_mod.load_state_dict_checked(net, sd)
        mean = hmr_mod.load_mean_params(mean_params_path)
        return HMRBundle(model=net.to(device), mean_params=mean)


def preprocess_hmr_image(image: np.ndarray, input_res: int = 224):
    """Resize (OpenCV's INTER_CUBIC, within one level: see
    ``io.images.resize_cubic``) and ImageNet-normalise: ``[1, res, res,
    3]`` float32, NHWC."""
    from bodyfitting_torch.io.images import resize_cubic

    img = resize_cubic(np.asarray(image, np.uint8), input_res, input_res)
    img = img.astype(np.float32) / 255.0
    img = (img - np.asarray(constants.IMG_NORM_MEAN)) / np.asarray(
        constants.IMG_NORM_STD)
    return img[None].astype(np.float32)


def hmr_init(image: Optional[np.ndarray], c2w: np.ndarray,
             bundle: Optional[HMRBundle] = None, stream=None):
    """Initial ``(betas [10], poses [72])`` (float32 numpy) for a fit from
    the keyframe: the HMR network's output when ``bundle`` and ``image``
    are given, else the mean pose; either way the global orientation is
    rotated into the world frame through the keyframe's camera-to-world
    rotation.  With ``stream`` (a CUDA stream) the network runs there,
    off the stream a fit is running on."""
    if bundle is not None and bundle.model is not None and image is not None:
        from bodyfitting_torch.models.hmr import hmr_forward

        dev = next(bundle.model.parameters()).device
        ctx = (torch.cuda.stream(stream) if stream is not None
               else contextlib.nullcontext())
        with ctx:
            x = torch.as_tensor(preprocess_hmr_image(image), device=dev)
            rotmat, betas, _ = hmr_forward(bundle.model, x,
                                           bundle.mean_params)
            rotmat = rotmat[0].cpu().numpy()
            betas = betas[0].cpu().numpy()
    else:
        rotmat = np.broadcast_to(np.eye(3, dtype=np.float32),
                                 (24, 3, 3)).copy()
        betas = np.zeros(10, np.float32)
    rotmat = np.array(rotmat)
    rotmat[0] = np.asarray(c2w)[:3, :3] @ rotmat[0]
    poses = rotmat_to_aa_np(rotmat).reshape(-1)
    return betas.astype(np.float32), poses.astype(np.float32)


def init_params_from_hmr(model, betas: np.ndarray, poses: np.ndarray,
                         device=None) -> smplify.FitParams:
    """``hmr_init``'s output as the initial :class:`FitParams` of one
    frame (betas cut or zero-padded to the model's count), on ``device``
    (default: the model's)."""
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
        init_body_pose=body_pose, device=device,
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

    Scan fits batch too: each frame keeps its own scan, height, constant
    scale and distance volume, as the JAX package's ``vmap`` of the fit
    does; the scans (and volumes) must share one shape, or
    :func:`smplify.concat_frames` raises.  Returns ``(FitParams, result
    dict, losses [B, num_iters])`` (``[B, 2 num_iters]`` and
    ``result["displacement"] [B, V, 3]`` with the SMPL+D stage).
    """
    obs = smplify.concat_frames(list(obs_list))
    init = smplify.concat_frames(list(init_list))
    return smplify.fit(model, config, obs, init, pose_prior_fn)


def smplx_init_from_smpl(smplx_model, smpl_result: dict,
                         device=None) -> smplify.FitParams:
    """Seed an SMPL-X fit (one frame) from a finished SMPL fit's result
    (numpy arrays of one frame): betas, global orientation, the first 21
    body joints, translation and scale carry over; hands and face start
    at zero."""
    pose = np.asarray(smpl_result["pose"], np.float32).reshape(-1)
    betas = np.zeros(smplx_model.num_betas, np.float32)
    src = np.asarray(smpl_result["betas"], np.float32).reshape(-1)
    n = min(len(betas), len(src))
    betas[:n] = src[:n]
    init = smplify.FitParams.init(
        smplx_model, init_betas=betas,
        init_global_orient=np.asarray(smpl_result["global_orient"],
                                      np.float32).reshape(-1),
        init_body_pose=pose[: 3 * smplx_model.num_body_joints],
        device=device)
    scale = np.asarray(smpl_result["scale"], np.float32).reshape(-1)
    transl = np.asarray(smpl_result["global_transl"], np.float32).reshape(-1)
    # the stored global_transl is transl * scale: undo it, keeping the
    # sign of a (degenerate) negative fitted scale
    safe = np.where(np.abs(scale) < 1e-8, 1e-8, scale).astype(np.float32)
    dev = init.global_transl.device
    dt = init.global_transl.dtype
    return dataclasses.replace(
        init,
        global_transl=torch.as_tensor(transl / safe, dtype=dt,
                                      device=dev)[None],
        body_scale=torch.as_tensor(scale, dtype=dt, device=dev)[None],
    )


def _pad_frames(items: list, multiple: int) -> tuple:
    """``items`` with the last repeated up to a multiple of ``multiple``,
    and the count of repeats."""
    pad = (-len(items)) % multiple
    return list(items) + [items[-1]] * pad, pad


def fit_frames_batched_sharded(model, config: smplify.FitConfig,
                               obs_list: Sequence[smplify.Observations],
                               init_list: Sequence[smplify.FitParams],
                               pose_prior_fn, mesh=None):
    """Data-parallel :func:`fit_frames_batched`: the batch's frames split
    over the ``frames`` axis of a ``(frames, views)`` mesh
    (:func:`bodyfitting_torch.parallel.sharding.make_mesh`; default: every
    rank of the initialised world).  Every rank passes the whole batch.

    Pads the batch by repeating the last frame up to a multiple of the
    frames dimension and strips the padding from every output."""
    from bodyfitting_torch.parallel import sharding as sh

    if mesh is None:
        mesh = sh.make_mesh(n_view_shards=1)
    n = len(obs_list)
    _, _, n_shards = sh.axis(mesh, "frames")
    obs_list, _ = _pad_frames(obs_list, n_shards)
    init_list, _ = _pad_frames(init_list, n_shards)
    params, results, losses = sh.fit_sequence_sharded(
        model, config, smplify.concat_frames(obs_list),
        smplify.concat_frames(init_list), pose_prior_fn, mesh=mesh)
    return (smplify.FitParams.from_tensors([t[:n] for t in params.tensors()]),
            {k: v[:n] for k, v in results.items()}, losses[:n])


def fit_sequence_batched(model, config: smplify.FitConfig,
                         obs_list: Sequence[smplify.Observations],
                         init_list: Sequence[smplify.FitParams],
                         pose_prior_fn, tcfg=None, mesh=None):
    """The temporally coupled fit (:func:`sequence.fit_sequence`) of a
    list of per-frame observations, optionally split over the ``frames``
    (and ``views``) axes of a mesh.

    With a mesh, the batch is padded by repeating the last frame; the
    padding frames carry zero weight through ``frame_valid`` (their data
    terms and every temporal term that touches them), so the real frames
    fit the unpadded objective.  Each rank fits its block's data terms;
    the temporal terms couple the blocks on the gathered sequence.
    Returns ``(results, losses [num_iters])``: the loss curve is the
    sequence's."""
    from bodyfitting_torch.fitting import sequence as seq

    tcfg = tcfg if tcfg is not None else seq.TemporalConfig()
    n = len(obs_list)
    if mesh is None:
        _, results, losses = seq.fit_sequence(
            model, config, smplify.concat_frames(list(obs_list)),
            smplify.concat_frames(list(init_list)), pose_prior_fn, tcfg)
        return results, losses

    from bodyfitting_torch.parallel import sharding as sh

    frames, _, n_shards = sh.axis(mesh, "frames")
    views, _, _ = sh.axis(mesh, "views")
    obs_list, pad = _pad_frames(obs_list, n_shards)
    init_list, _ = _pad_frames(init_list, n_shards)
    obs = smplify.concat_frames(obs_list)
    init = smplify.concat_frames(init_list)
    frame_valid = torch.cat([torch.ones(n), torch.zeros(pad)]).to(
        dtype=init.global_transl.dtype, device=init.global_transl.device)
    params, results, losses = seq.fit_sequence(
        model, config, sh.obs_sharding(mesh, obs),
        sh.params_sharding(mesh, init), pose_prior_fn, tcfg,
        frame_valid=frame_valid, frame_group=frames, view_group=views)
    _, results, _ = sh.gather_frames(mesh, params, results, losses)
    return {k: v[:n] for k, v in results.items()}, losses


def check_smpl_fitting(image: np.ndarray, verts, c2w, K) -> np.ndarray:
    """The reprojection overlay: ``image`` with a green plus (OpenCV's
    filled circle of radius 1) at each projected vertex inside it."""
    w2c = np.linalg.inv(np.asarray(c2w))
    cam = np.asarray(verts) @ w2c[:3, :3].T + w2c[:3, 3]
    proj = cam @ np.asarray(K).T
    with np.errstate(invalid="ignore", divide="ignore"):
        uv = proj[:, :2] / np.maximum(proj[:, 2:3], 1e-9)
    out = image.copy()
    h, w = out.shape[:2]
    ok = np.isfinite(uv).all(1) & (np.abs(uv) < 2 ** 31).all(1)
    xy = uv[ok].astype(np.int64)                  # truncation, as int()
    xy = xy[(xy[:, 0] >= 0) & (xy[:, 0] < w) & (xy[:, 1] >= 0)
            & (xy[:, 1] < h)]
    green = np.zeros(out.shape[2:], out.dtype)
    green[..., 1] = 255
    for dx, dy in ((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1)):
        x, y = xy[:, 0] + dx, xy[:, 1] + dy
        keep = (x >= 0) & (x < w) & (y >= 0) & (y < h)
        out[y[keep], x[keep]] = green
    return out


def save_frame_outputs(output_folder: str, smpl_type: str, model,
                       result: dict, images=None, c2ws=None, Ks=None,
                       use_frames=None, render_skip: int = 12,
                       debug: bool = False) -> None:
    """A frame's ``{smpl_type}_parameter.npy`` and ``{smpl_type}.obj``
    (``+d.obj`` with a displacement), and with ``debug`` the reprojection
    overlays ``smpl_fitting/%02d.png`` named after ``use_frames``."""
    from bodyfitting_torch.io.images import imwrite
    from bodyfitting_torch.io.params import save_fit_outputs

    save_fit_outputs(output_folder, smpl_type, result,
                     model.faces.cpu().numpy(),
                     displacement=result.get("displacement"))
    if debug and images is not None:
        fit_dir = os.path.join(output_folder, "smpl_fitting")
        os.makedirs(fit_dir, exist_ok=True)
        frames = use_frames or list(range(len(images)))
        if len(frames) != len(images):
            raise ValueError(f"use_frames ({len(frames)}) must align 1:1 "
                             f"with images ({len(images)})")
        verts = np.asarray(result["vertices"])
        for idx in range(0, len(images), render_skip):
            imwrite(os.path.join(fit_dir, "%02d.png" % frames[idx]),
                    check_smpl_fitting(images[idx], verts, c2ws[idx],
                                       Ks[idx]))


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
