"""A production-shape problem for the multi-device fits.

Counterpart of ``bodyfitting_tpu/parallel/checks.py``: a whole staged
SMPL-X fit (keypoints, then mask and mesh past the stage gate) at real
asset size, whose frames and views split over a ``(frames, views)``
mesh.  The same numpy draws as the JAX function give the same arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bodyfitting_torch.device import default_device
from bodyfitting_torch.fitting import smplify
from bodyfitting_torch.losses.priors import synthetic_gmm_prior
from bodyfitting_torch.losses.silhouette import _outer_contours
from bodyfitting_torch.models import body_model as bm
from bodyfitting_torch.ops import sdf
from bodyfitting_torch.ops.camera import perspective_projection


def make_production_fit_problem(rng=None, num_iters: int = 60,
                                n_frames: int = 8, device=None):
    """A staged fit at production shape: the SMPL-X-sized synthetic model
    (V = 10,475), ``use_mask`` and ``use_mesh`` on the distance-volume
    route, 4 keypoint views, 2 masks of 128^2 with 256 contour points, a
    2,048-vertex sphere scan with its 24^3 volume, ``num_iters``
    iterations across the stage gate.  Returns ``(model, config, obs,
    init, prior)`` batched over ``n_frames`` frames, on ``device``
    (default ``cuda``).  The contours are OpenCV's ``findContours``
    points (:func:`~bodyfitting_torch.losses.silhouette._outer_contours`
    computes them without OpenCV)."""
    device = default_device(device)
    if rng is None:
        rng = np.random.default_rng(0)
    model = bm.synthetic_model("smplx", num_verts=10475, seed=0,
                               device=device)
    prior = synthetic_gmm_prior(device=device)
    config = smplify.FitConfig(num_iters=num_iters, imsize=512.0,
                               use_mask=True, use_mesh=True,
                               mesh_loss_impl="sdf")

    n_views, n_mask_views = 4, 2
    H, Pc = 128, 256

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    K = t([[500.0, 0, 256], [0, 500.0, 256], [0, 0, 1]])
    w2c = torch.eye(4, device=device)
    w2c[2, 3] = 3.0

    # ground-truth-like keypoints: the zero pose's joints projected, plus
    # per-frame noise
    with torch.no_grad():
        out0 = bm.forward(model, bm.BodyParams.zeros(model))
        uv = perspective_projection((out0.joints[0] * 0.3)[None],
                                    w2c[None, :3, :3], w2c[None, :3, 3],
                                    K[None])[0]
    kps = torch.cat([uv, torch.ones_like(uv[:, :1])], 1)
    kps = kps.expand((n_frames, n_views) + kps.shape)
    kps = kps + t(rng.normal(scale=2.0, size=tuple(kps.shape))) * t(
        [1.0, 1.0, 0.0])

    # the scan: a sphere-mesh surface at body scale and its volume
    sv, sf = bm.sphere_mesh(2048, np.random.default_rng(3))
    sv = t(sv * 0.25)
    sf = torch.as_tensor(sf.astype(np.int64), device=device)
    vol = sdf.build_distance_volume(sv, sf, resolution=24)

    masks = np.zeros((n_mask_views, H, H), np.float32)
    masks[:, 28:100, 40:88] = 1.0
    conts, valid = [], []
    for m in masks:
        c = _outer_contours(m)[0]
        idx = np.linspace(0, len(c), Pc, endpoint=False).astype(int)
        conts.append(c[idx])
        valid.append(np.full(Pc, len(c) / Pc, np.float32))
    Km = t([[120.0, 0, 64], [0, 120.0, 64], [0, 0, 1]])

    def batch(x):
        x = torch.as_tensor(x, device=device)
        return x.expand((n_frames,) + x.shape).contiguous()

    obs = smplify.Observations(
        w2cs=batch(w2c[None].expand(n_views, 4, 4)),
        Ks=batch(K[None].expand(n_views, 3, 3)),
        keypoints=kps.contiguous(),
        view_mask=torch.ones((n_frames, n_views), device=device),
        constant_scale=torch.full((n_frames,), 0.3, device=device),
        masks=batch(np.stack(masks)),
        mask_w2cs=batch(w2c[None].expand(n_mask_views, 4, 4)),
        mask_Ks=batch(Km[None].expand(n_mask_views, 3, 3)),
        contours=batch(np.stack(conts)),
        contour_valid=batch(np.stack(valid)),
        scan_verts=batch(sv),
        scan_faces=batch(sf),
        scan_height=torch.full((n_frames,),
                               float(sv[:, 1].max() - sv[:, 1].min()),
                               device=device),
        scan_volume=sdf.DistanceVolume(**{
            f.name: batch(getattr(vol, f.name))
            for f in dataclasses.fields(vol)}),
    )
    init = smplify.FitParams.init(model, batch=n_frames)
    return model, config, obs, init, prior
