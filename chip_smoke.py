#!/usr/bin/env python3
"""Start the PyTorch port (``bodyfitting_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments, on a machine with one
CUDA card, ``nvcc`` (``/usr/local/cuda``) and scipy:

    python3 chip_smoke.py              # add --profile for a kernel trace

``--save-volume NPZ`` also writes the scan problem, its distance volume
and the SDF fit's result, for ``python -m tests.scan_fit_vs_jax NPZ``
(the same fit by the JAX package on the CPU); ``--save-rp NPZ`` phase
10's scan and joints, for ``python -m tests.rp_mask_fit_vs_jax NPZ``.

Phases; the first failure ends the run with a non-zero exit code:

1. device: require CUDA; print the card's name and power limit.
2. build: compile ``bodyfitting_torch/ops/csrc/*.cu`` for ``sm_90a``.
3. main path: the staged SMPL-X mask fit at the GeneBody production
   shape ("3b" in ``bench_configs.py``): 8 frames, 48 keypoint views,
   8 ground-truth mask views at 512x512 on content crops, contours
   resampled to 512 points, every 4th of 10475 vertices (2619) in the
   silhouette term, 600 Adam iterations with the mask term on after step
   200.  Model and pose prior are the synthetic ones from seed 0 (the
   licensed SMPL-X and GMM files are not in the repository); keypoints
   and masks are rendered from seeded ground-truth bodies.  The launch
   counters are zeroed just before the fit and read just after it; the
   loss trace's sha1 is printed (the kernels are deterministic, so runs
   on one card that agree elsewhere agree on it).
4. checks: the loss is finite, the mask term is live after the gate and
   the masked stage descends; at the fit's final state
   the loss and its gradient with the kernels equal those with the plain
   PyTorch versions on the card; a small fit on the card equals the same
   fit on the CPU (plain versions).
5. kernels: each kernel bitwise against its plain version on the inputs
   the main path gave it at its final state, and on edge cases: for the
   sampler, its two calls (the stay-inside sample and the matched-pixel
   lookup, on the bit-mask crops the fit's step reads) in its two image
   types (bit mask, f32) and three flag sets, NaN and far points,
   exact integers, border points, H or W of 1, point counts that leave a
   block half full; for the contour match and the scatter, exact ties at
   the lane stride, one valid candidate, M = 1, P = 1, NaN points,
   70,000 candidates, all entries on one output, out-of-range indices,
   rows of several chunks.  With the launch geometry and the input
   statistics the designs depend on, and timed beside the plain version
   and a PyTorch call that computes (nearly) the same function; the
   sampler warm and cold (the L2 flushed before each launch).
6. scan path: RenderPeople's SMPLify + SMPL+D fit of one scan with the
   synthetic SMPL model (6846 vertices, SPIN joints).  The scan is a
   seeded ground-truth body subdivided twice (219,008 faces) and pushed
   out 5-15 mm along its normals; keypoints on 8 ring views at 512^2;
   the mean-pose init.  With the counters zeroed: the 96^3 distance
   volume (14 chunks through the nearest-point kernel) and the 600 + 600
   SDF fit; then the exact route, 90 + 90 at full width, one kernel
   launch per post-gate and per displacement step.  Checks: finite loss,
   the point-to-scan term live after the gate, the displacement stage
   descends, the kernel equals its plain version (d2 bitwise, idx
   exactly) at a volume chunk and at the exact fit's final query, and
   loss and gradient agree with the plain version there.
7. the kernel's times at the volume chunk and the in-fit query, beside
   its bound: the bytes it must move, or the operations of the pairs
   that per-face bounding boxes cannot rule out on this data.
8. texture stage: RenderPeople's prep renders and ``run_texfit`` on the
   scan phase's scan and SDF fit (SMPL vertices plus displacements),
   with the ``--auto_uv`` per-face atlases (the licensed UV template is
   not in the repository).  The scan gets a 2048^2 atlas baked from a
   smooth seeded colour field (one ``rasterize_zbuf`` launch); 8 ring
   views at 512^2 (8 launches); ``fit_texture`` with
   ``TextureFitConfig()``: 200 iterations over 128 unique poses, 256
   ``rasterize_attrs`` launches; the 1024^2 atlas raster (one launch),
   hole fill, the grey-texel unseen mask, diffusion inpainting, LBAM
   with seeded weights, the displacement bake.  Counters zeroed around
   the stage.  Checks: finite losses, every view covered, the ring-view
   L1 of the fitted texture below the grey one's, both kernels equal to
   their plain versions (depth and attributes bitwise, face indices
   exactly) at a scan view and at a scan and a SMPL pose, LBAM on the
   card vs the CPU at 256^2, a small texture fit card vs CPU; then both
   kernels timed beside their bound (bytes, or 25 operations a pixel-face
   pair whose face box holds the pixel centre).

9. the GeneBody app, ``python -m bodyfitting_torch.apps.genebody`` run
   through ``main(argv)`` with ``FUSED_SKINNING = "on"``: a synthetic
   subject written with the port's own writers to a temporary directory
   (48 ring cameras in ``annots.npy``, 2448x2048 mask PNGs for 16 frames x
   48 views, the listing and HMR keyframe images, OpenPose JSONs of
   seeded SMPL-X bodies in each view's crop, which stand in for the
   openpose.bin run); (a) the default keypoint-only SMPL-X run with a
   seeded HMR checkpoint and ``--timing``, 16 frames in two batches of 8
   through the pipelined loop; (b) ``--use_mask`` and (c) ``--temporal``
   on 8 frames; 600 iterations each at ``--load_size 512``, the synthetic
   SMPL-X at 10,475 vertices.  The counters are zeroed around each run.
   Checks: every frame's OBJ and parameters (the JAX app's keys, finite),
   the fitted joints' reprojection onto the ground truth's keypoints, the
   masked stage's descent, the skinning launch counts (one forward and
   one backward a step, one forward a batch for the output), the kernels
   bitwise against their plain versions at every shape the app gave them,
   and the mask loss and gradient with the kernels against the matmul
   path; then the kernels timed there and at 128 frames of full width,
   beside their bound, their -fmad=false issue floor and the times of
   their previous design, with each launch's geometry.  Each run's fitted
   parameters are hashed (sha1): the kernels equal the same plain
   versions in every design, so the hash holds across designs.

10. the RenderPeople app, ``python -m bodyfitting_torch.apps.renderpeople``
   run through ``main(argv)``: first the committed JPEG fixtures
   (``tests/data/jpeg/``) decoded by the port, each to the sha1 of
   OpenCV's decode recorded beside it.  Then a synthetic RenderPeople
   directory in a temporary directory: the scan phase's 219,008-face scan
   as an OBJ with cylindrical UVs (``v``, ``vt``, ``f v/vt``), an MTL
   whose ``map_Kd`` names the 2048^2 JPEG fixture, the scan phase's
   synthetic SMPL written as a model file (``--model_path``), OpenPose
   BODY_25 JSONs of the ground truth's joints in the app's own ring views,
   the seeded HMR checkpoint.  (a) ``--tasks smplify smpld texfit output
   --auto_uv --inpaint --disp_map --debug --timing``, 600 + 600 fit
   iterations, 200 texture iterations; (b) ``--tasks texfit output`` on
   (a)'s output directory (its cached views and fit); (c) ``--use_mask
   --tasks smplify``, 120 iterations; (a2) (a)'s smplify and smpld tasks
   again in a fresh directory, whose parameters must equal (a)'s bit for
   bit (SMPL+D sums in a fixed order), and the vertex normals with their
   gradient on (a)'s SMPL+D, two calls bitwise equal.  ``--save-rp NPZ``
   keeps the scan and its joints for ``python -m
   tests.rp_mask_fit_vs_jax NPZ``.  The counters are zeroed around each
   run and held to the counts the code gives: (a) 14 ``nearest_d2_idx``
   (the 96^3 volume), 81 ``rasterize_zbuf`` (8 views, the 1024^2 atlas,
   2 x 36 ``render_compare`` views), 256 ``rasterize_attrs``; (b) 0 / 73 /
   256; (c) 14 / 8 / 0 and 158 / 79 / 79 of the silhouette kernels.
   Checks: every file the JAX app writes exists and holds finite values;
   SMPL+D lies within 10 mm of the scan on average; the fitted joints
   reproject within 20 px of the ground truth's keypoints on average; the
   fitted texture's ring-view L1 is below grey's; (b)'s ``smpl.png``
   equals (a)'s byte for byte; (c)'s mask term is live after the gate.
   The three silhouette kernels' arguments at (c)'s last step (f32 full
   masks with coverage, the app's contour and vertex counts) are kept, and
   each kernel is held bitwise against its plain version there and timed
   beside it, the library call and the bound (the kernel table's
   ``rp_app_c``).  Printed: the OBJ parse and JPEG decode times, each
   run's stages (``--timing``), launches and parameter sha1.

11. the native OpenPose detector and ``fit_resumable``: phase 9's subject
   for 2 frames with an RGB image for every view (the body's splat,
   shaded, on a plain background).  Seeded body, hand and face weights
   in the released flat layout are written to a temporary
   ``--openpose_ckpt_dir``, each last-stage head set channel by channel
   on frame 0's crops so a view yields a few peaks a part (random nets
   give thousands) and the PAFs point along an upright skeleton's limbs.
   Under PyTorch's default ``cudnn.allow_tf32`` (printed): (a) ``--tasks
   openpose --native_openpose`` at ``--load_size 512`` through the app:
   one parseable JSON a view, read back by ``load_openpose``; the
   detector's seconds a frame, its FLOP (counted from the convolutions'
   shapes) and TFLOP/s per net, its parts timed apart (each scale's
   batch, hands, face, the peaks on the card, the PAF gather, the host
   assembly) and the bytes copied to the host; the body pass at 368^2
   with TF32 on and off; (b) on 2 views the body maps at scale 0.5, card
   (TF32 on and off) against the CPU, and the card's peaks and people
   against the host path on the card's maps, exactly; (c) ``--tasks
   smplify output`` on (a)'s JSONs, 60 iterations; (d)
   ``fit_resumable`` on phase 3's problem in chunks of 100, stopped at
   step 300 (past the gate) and resumed by a fresh call: parameters and
   loss trace bitwise phase 3's; the checkpoint's bytes and its save
   and load ms.

12. the rest of the single-device package: (a) ``python -m
   bodyfitting_torch.tools.validate_assets`` through ``main(argv)`` with
   ``FUSED_SKINNING = "on"`` on seeded files written to a temporary
   directory (an SMPL-X ``.npz`` of 10,475 vertices, the GMM, HMR,
   OpenPose body, hand and face and LBAM checkpoints in the released
   layouts): exit code 0 with every row PASS, then 1 with the lbs row FAIL
   on broken skinning weights; the skinning kernel at the SMPL-X forward's
   arguments against its plain version, timed.  (b) phase 6's scan and the
   same scan turned 90 degrees about the vertical and moved 0.1 m (its
   cameras with it) fitted as one batch by ``fit_frames_batched``: both
   96^3 volumes and the 600 + 600 SDF fit, then the exact route's 90 + 90;
   scan 0 against phase 6's fit, scan 1's distance to its scan against
   phase 6's, the nearest kernel at scan 1's last query against its plain
   version, timed; frame 0 alone against frame 0 of the batch at the
   first step and after the gate (forward, each loss term, each
   parameter's gradient), bitwise, which names the sums that round
   otherwise at B 2; the body and displacement sha1s of phase 6's fit
   and of scan 0, for comparing runs.  (c) ``render_fit_overlays`` of
   phase 9's keypoint fit
   on its 2448 x 2048 views (every 12th): each z-buffer launch against the
   plain version, timed; the card against the CPU on one view at 1/4
   size.  (d) ``soft_silhouette`` of phase 3's body at 512^2, forward and
   backward, timed with its peak memory; against the CPU at 128^2; IoU
   with the hard raster at sigma 1e-6.  (e) ``inside_mesh`` and
   ``intersects_any`` of the fitted SMPL's vertices against the scan,
   timed; the card against the CPU on 512 queries.  The counters are
   zeroed around each of (a), (b)'s two routes and (c), and held to the
   counts the code gives: 2 ``skin_forward``; 28 and 298
   ``nearest_d2_idx``; 4 ``rasterize_zbuf``.

13. the multi-device fits (``bodyfitting_torch/parallel``): (a) a world
   of one on NCCL: ``fit_sequence_sharded`` on
   ``make_production_fit_problem`` (8 frames, SMPL-X at 10,475 vertices,
   4 views, 2 masks of 128^2, the 24^3 volume, 60 iterations) bitwise
   ``fit_frames_batched`` on the same inputs, the gate's loss jump above
   1.5x, both timed; the counters zeroed before the problem's volume
   build and read after the sharded fit.  (b) two ranks spawned on card
   0 over gloo (NCCL refuses two ranks on one card): the 2x1 and 1x2
   meshes against (a)'s single-device fit (pre-gate losses to 1e-3, the
   last to 0.2, as the JAX package's hardware check), each rank's 2x1
   block bitwise its block fitted alone; the collectives counted, and a
   step's and the end gathers replayed and timed.  (c) the temporal fit
   of 3 frames over 2x1 (one padding frame) against the unsharded
   temporal fit: every step's loss and the vertices to 1e-4 relative.
   (d) the SMPL-X forward vertex-sharded over the two ranks (auto-padded
   to 10,476) under ``FUSED_SKINNING = "on"`` against the whole model's
   plain forward (2e-5), pad rows exactly 0, each rank's
   ``skin_forward`` launch (5,238 rows) held bitwise against its plain
   version on its inputs and timed on rank 0.  (e) phase 9's keypoint
   run on 2 frames with and without ``--data_parallel`` (a world of
   one): equal parameter sha1s.  (f) the three silhouette kernels at
   (a)'s last step and the nearest kernel at the 24^3 build, each
   bitwise its plain version, timed beside the library call and the
   bound (the kernel table's rows with ``"phase": 13``, with (d)'s).

14. the fused per-view mask term (``FUSED_MASK_TERM = "fused"``), run
   right after phase 5 on phase 3's fit: (a) the fit's loss and
   gradient at its final state through the fused and the separate
   route (1e-5), the fused kernels' arguments recorded there; (b)
   ``mask_terms_forward`` (two launches for all 64 views) and
   ``mask_terms_backward`` (one) bitwise their plain versions on those
   arguments, and a second launch bitwise the first; (c) the routes at
   the recorded projection: each view's ICP and stay-inside terms
   (1e-5 relative) and the projection's gradient (2e-6 of its largest
   entry); (d) 20 post-gate steps of the fit a route, in turns
   (separate, fused, fused, separate), ms a step on the host clock, the
   counters zeroed around the first fused run (2 forward launches and 1
   backward a step; the separate kernels none); (e) 10 post-gate steps
   a route under torch.profiler: kernels and copies a step, and exactly
   one launch of each fused kernel a fused step; (f) each route's
   forward and backward a call: device busy time and kernels
   (profiler), host time; the kernels timed beside their plain versions
   and their bound.

The line before the last is the kernel table as one JSON object (phase
12's three rows, phase 13's five and phase 14's two carry a ``phase``
key); the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CUDNN_TF32_DEFAULT = True     # PyTorch's default; phase_device reads it

# Published peaks of one H100 SXM (NVIDIA data sheet), at a 700 W limit.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12          # float32 outside the tensor cores

# The main path's shape: the GeneBody "3b" production shape at 8 frames.
MAIN_PATH = dict(num_verts=10475, n_frames=8, n_views=48, n_mask_views=8,
                 imsize=512, focal=900.0, dist=2.0, contour_points=512,
                 num_iters=600)

# The scan path's shape: RenderPeople's SMPL+D fit (--smpl_type smpl,
# --viewnum 8 --load_size 512) of a 219,008-face scan, the 96^3 volume
# build of the default mesh_loss_impl="sdf", 600 + 600 iterations; the
# exact nearest-point route at full width and a cut depth.
SCAN_PATH = dict(num_verts=6890, n_views=8, imsize=512, subdivisions=2,
                 sdf_resolution=96, num_iters=600, exact_iters=90)

TPU_KERNELS = {
    "bilinear_cov_grads": "bodyfitting_tpu/ops/pallas_kernels.py:1242",
    "contour_match_full": "bodyfitting_tpu/ops/pallas_kernels.py:1620",
    "rows_scatter_add": "bodyfitting_tpu/ops/pallas_kernels.py:1738",
    "nearest_d2_idx": "bodyfitting_tpu/ops/pallas_kernels.py:49",
    "rasterize_zbuf": "bodyfitting_tpu/ops/pallas_kernels.py:445",
    "rasterize_attrs": "bodyfitting_tpu/ops/pallas_kernels.py:641",
}
SOURCES = {
    "bilinear_cov_grads": "bodyfitting_torch/ops/csrc/bilinear.cu",
    "contour_match_full": "bodyfitting_torch/ops/csrc/contour_match.cu",
    "rows_scatter_add": "bodyfitting_torch/ops/csrc/rows_scatter.cu",
    "nearest_d2_idx": "bodyfitting_torch/ops/csrc/nearest.cu",
    "rasterize_zbuf": "bodyfitting_torch/ops/csrc/raster.cu",
    "rasterize_attrs": "bodyfitting_torch/ops/csrc/raster.cu",
}


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# The problem: seeded ground-truth bodies seen by a ring of cameras
# ---------------------------------------------------------------------------


def ring_cameras(n, imsize, focal, dist, height=None):
    """``n`` cameras on a horizontal ring, all looking at the origin, for
    images ``imsize`` wide and ``height`` (default ``imsize``) high."""
    height = imsize if height is None else height
    c2ws, Ks = [], []
    for th in np.linspace(0, 2 * np.pi, n, endpoint=False):
        eye = np.array([dist * np.sin(th), 0.0, dist * np.cos(th)])
        z = -eye / np.linalg.norm(eye)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        c2w = np.eye(4)
        c2w[:3, :3] = np.stack([x, np.cross(z, x), z], 1)
        c2w[:3, 3] = eye
        c2ws.append(c2w.astype(np.float32))
        Ks.append(np.array([[focal, 0, imsize / 2], [0, focal, height / 2],
                            [0, 0, 1]], np.float32))
    return c2ws, Ks


def project(pts, c2w, K):
    w2c = np.linalg.inv(c2w)
    uv = (pts @ w2c[:3, :3].T + w2c[:3, 3]) @ K.T
    return uv[:, :2] / uv[:, 2:3]


def splat_mask(pts_uv, imsize, dilate, height=None):
    """A filled silhouette from projected vertices (no OpenCV), ``imsize``
    wide and ``height`` (default ``imsize``) high."""
    from scipy import ndimage

    height = imsize if height is None else height
    uv = np.round(pts_uv).astype(np.int64)
    ok = (uv >= 0).all(1) & (uv < [imsize, height]).all(1)
    m = np.zeros((height, imsize), bool)
    m[uv[ok, 1], uv[ok, 0]] = True
    m = ndimage.binary_fill_holes(ndimage.binary_dilation(m, iterations=dilate))
    return m.astype(np.float32)


def make_problem(model, n_frames, n_views, n_mask_views, imsize, focal,
                 dist, contour_points, seed, device, init_noise=0.1):
    """Per-frame Observations and initial parameters of ``n_frames``
    seeded ground-truth bodies, built by the port's own entry points.

    Each frame starts from its ground-truth orientation and pose plus
    seeded noise of scale ``init_noise`` (radians), with zero shape, no
    translation and unit scale: a stand-in for the HMR keyframe init that
    the GeneBody app gives the fit."""
    import torch

    from bodyfitting_torch.fitting import body_fitting as bf
    from bodyfitting_torch.fitting import smplify
    from bodyfitting_torch.losses.silhouette import compute_mask_crops
    from bodyfitting_torch.models import body_model as bm

    rng = np.random.default_rng(seed)
    B = n_frames

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=model.device)

    orient = np.zeros((B, 3))
    orient[:, 0] = 0.1
    orient[:, 1] = rng.uniform(-0.3, 0.3, size=B)
    gt = dataclasses.replace(
        bm.BodyParams.zeros(model, B),
        body_pose=t(rng.normal(scale=0.15, size=(B, 3 * model.num_body_joints))),
        betas=t(rng.normal(scale=0.5, size=(B, model.num_betas))),
        global_orient=t(orient),
    )
    with torch.no_grad():
        out = bm.forward(model, gt)
    transl = rng.normal(scale=0.03, size=(B, 1, 3))
    scale = 0.3 * 1.15
    joints = (out.joints.cpu().numpy() + transl) * scale
    verts = (out.vertices.cpu().numpy() + transl) * scale

    c2ws, Ks = ring_cameras(n_views, imsize, focal, dist)
    mask_ids = list(range(0, n_views, n_views // n_mask_views))[:n_mask_views]
    frames = []
    for f in range(B):
        kps = []
        for c2w, K in zip(c2ws, Ks):
            uv = project(joints[f], c2w, K)
            uv = uv + rng.normal(scale=1.0, size=uv.shape)
            kp = np.concatenate([uv, np.ones((len(uv), 1))], 1)
            kp = kp.astype(np.float32)
            # OpenPose face order: 17 contour points, then 51 inner ones
            face = np.concatenate([kp[67 + 51:], kp[67:67 + 51]])
            kps.append(dict(pose=kp[:25], hand_left=kp[25:46],
                            hand_right=kp[46:67], face=face))
        masks = [splat_mask(project(verts[f, ::4], c2ws[i], Ks[i]), imsize,
                            dilate=max(imsize // 256, 1))
                 for i in mask_ids]
        frames.append((kps, masks))
    # one crop shape for the batch: the largest content box of any frame
    crop_hw = tuple(int(x) for x in np.max(
        [compute_mask_crops(m)[2] for _, m in frames], axis=0))
    obs_list = [
        bf.build_observations(
            c2ws, Ks, kps, use_hand_face=True, masks=masks,
            mask_c2ws=[c2ws[i] for i in mask_ids],
            mask_Ks=[Ks[i] for i in mask_ids], mask_num_views=n_mask_views,
            mask_imsize=imsize, contour_pad=8 * imsize,
            contour_resample=contour_points,
            mask_crop=True, mask_crop_hw=crop_hw, device=device,
        )
        for kps, masks in frames
    ]
    init_list = [
        smplify.FitParams.init(
            model,
            init_global_orient=gt.global_orient[f:f + 1] + t(
                rng.normal(scale=init_noise, size=(1, 3))),
            init_body_pose=gt.body_pose[f:f + 1] + t(
                rng.normal(scale=init_noise, size=gt.body_pose[:1].shape)),
        )
        for f in range(B)
    ]
    return obs_list, init_list, crop_hw


def subdivide(verts, faces):
    """Midpoint subdivision: each triangle into four, edge midpoints
    shared between neighbours."""
    F = len(faces)
    edges = np.sort(np.concatenate(
        [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]), axis=1)
    uniq, inv = np.unique(edges, axis=0, return_inverse=True)
    mid = len(verts) + inv.reshape(3, F).T               # m01, m12, m20
    verts = np.concatenate([verts, 0.5 * (verts[uniq[:, 0]]
                                          + verts[uniq[:, 1]])])
    a, b, c = faces.T
    m01, m12, m20 = mid.T
    faces = np.concatenate([
        np.stack([a, m01, m20], 1), np.stack([m01, b, m12], 1),
        np.stack([m20, m12, c], 1), np.stack([m01, m12, m20], 1)])
    return verts, faces.astype(np.int64)


def vertex_normals(verts, faces):
    """Area-weighted unit vertex normals (numpy)."""
    fn = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]],
                  verts[faces[:, 2]] - verts[faces[:, 0]])
    vn = np.zeros_like(verts)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    return vn / np.maximum(np.linalg.norm(vn, axis=1, keepdims=True), 1e-12)


def make_scan_problem(model, n_views, imsize, subdivisions, seed,
                      with_joints=False):
    """A seeded RenderPeople-style scan problem for a SMPL ``model`` (with
    the SPIN joint mapper): ``(c2ws, Ks, keypoints, scan_verts,
    scan_faces)``, and the ground truth's 25 BODY_25 joints after them
    ``with_joints``.

    The scan is the posed ground-truth surface, midpoint-subdivided
    ``subdivisions`` times, pushed out along its normals by a smooth
    5-15 mm offset that stands in for clothing.  Keypoints are the
    ground truth's 25 BODY_25 joints on ``n_views`` ring views at
    ``imsize``², focal ``imsize`` and distance height / 0.8, as the
    RenderPeople app renders its scans, with 1 px of seeded noise."""
    import torch

    from bodyfitting_torch.models import body_model as bm

    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=model.dtype,
                               device=model.device)[None]

    gt = dataclasses.replace(
        bm.BodyParams.zeros(model, 1),
        body_pose=t(rng.normal(scale=0.15, size=3 * model.num_body_joints)),
        betas=t(rng.normal(scale=0.5, size=model.num_betas)),
        global_orient=t([0.05, rng.uniform(-0.3, 0.3), 0.0]),
    )
    with torch.no_grad():
        out = bm.forward(model, gt)
    verts = out.vertices[0].double().cpu().numpy()
    joints = out.joints[0, :25].double().cpu().numpy()
    faces = model.faces.cpu().numpy().astype(np.int64)
    for _ in range(subdivisions):
        verts, faces = subdivide(verts, faces)
    offset = 0.010 + 0.005 * np.sin(7.0 * verts[:, 1]) * np.cos(
        5.0 * verts[:, 0] + 3.0 * verts[:, 2])          # 5-15 mm
    scan_verts = verts + offset[:, None] * vertex_normals(verts, faces)
    height = float(np.ptp(scan_verts[:, 1]))
    c2ws, Ks = ring_cameras(n_views, imsize, float(imsize), height / 0.8)
    kps = []
    for c2w, K in zip(c2ws, Ks):
        uv = project(joints, c2w, K) + rng.normal(scale=1.0, size=(25, 2))
        kps.append(dict(pose=np.concatenate(
            [uv, np.ones((25, 1))], 1).astype(np.float32)))
    out = (c2ws, Ks, kps, scan_verts.astype(np.float32), faces)
    return out + (joints,) if with_joints else out


# ---------------------------------------------------------------------------
# Kernel swaps, loss and gradient at one state, timing
# ---------------------------------------------------------------------------

KERNEL_NAMES = ("bilinear_cov_grads", "contour_match_full", "rows_scatter_add")
# the fused per-view mask term's kernels (FUSED_MASK_TERM = "fused")
FUSED_NAMES = ("mask_terms_forward", "mask_terms_backward")


@contextlib.contextmanager
def silhouette_ops(replace, names=KERNEL_NAMES):
    """Temporarily replace the silhouette loss's kernel entry points
    ``names``: ``replace(name, fn)`` returns the function to call
    instead."""
    from bodyfitting_torch.losses import silhouette as sil

    orig = {n: getattr(sil, n) for n in names}
    for n, fn in orig.items():
        setattr(sil, n, replace(n, fn))
    try:
        yield
    finally:
        for n, fn in orig.items():
            setattr(sil, n, fn)


def plain_versions(name, fn):
    from bodyfitting_torch.ops import kernels as K

    return getattr(K, f"{name}_plain")


def loss_and_grads(models, config, params, obs, prior, step):
    import torch

    from bodyfitting_torch.fitting import smplify

    loss_model, joints_model, rows = models
    leaves = [p.detach().clone().requires_grad_(True)
              for p in params.tensors()]
    # the observations as the fit's step reads them (bit-mask crops)
    loss, _ = smplify.fit_loss(
        loss_model, config, smplify.FitParams.from_tensors(leaves),
        smplify.step_observations(obs), step, prior,
        joints_model=joints_model, mask_vertex_rows=rows)
    grads = torch.autograd.grad(loss.sum(), leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), [g.detach() for g in grads]


def cuda_ms(fn, reps=50, warmup=5):
    """Mean device milliseconds of ``fn()`` over ``reps`` back-to-back
    calls, between two CUDA events, after ``warmup`` calls.  A spin
    kernel holds the stream while the host queues the calls, so the
    host's per-call cost (Python, checks, allocation) stays out of the
    time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)          # ~50 ms of device clock cycles
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cold_ms(fn, reps=200, flush_mib=128):
    """``(median, mean)`` device milliseconds of ``fn()`` with the L2 cold:
    before each call a ``flush_mib`` MiB write evicts the 50 MB L2, and
    each call is timed by its own pair of CUDA events (a spin kernel holds
    the stream while the host queues the calls)."""
    import torch

    flush = torch.empty(flush_mib * 2 ** 20 // 4, device="cuda")
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(200_000_000)          # ~100 ms of device clock cycles
    for i, (start, end) in enumerate(events):
        flush.fill_(float(i))
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    times = [a.elapsed_time(b) for a, b in events]
    return float(np.median(times)), float(np.mean(times))


def host_ms(fn, reps=50):
    """Milliseconds per call on the host clock, the stream drained at both
    ends: the larger of the host's cost and the device's."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / reps * 1e3


def bound_ms(nbytes, flops):
    """Least time for the work: bytes over HBM rate, or f32 operations
    over the f32 peak, whichever is larger."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / F32_FLOPS_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def match_edge_cases(card=False):
    """Single rows that probe the contour kernel's design, as numpy
    ``(contour [P, 2], proj [M, 2], valid [M], inside [M])`` by name.
    Coordinates are integers and half-integers, so every d2 is exact and
    ties are ties on any hardware.  ``card=True`` adds the cases the
    Pallas kernel does not share: NaN points (the Pallas argmin takes a
    NaN), and a row of 70,000 candidates (several shared-memory tiles)."""
    rng = np.random.default_rng(7)

    def row(P, M):
        proj = np.round(rng.uniform(0, 64, size=(M, 2))).astype(np.float32)
        contour = np.round(rng.uniform(-5, 70, size=(P, 2))).astype(
            np.float32)
        inside = rng.random(M).astype(np.float32)
        return contour, proj, np.ones(M, np.float32), inside

    cases = {}
    # copies of one point at the lane stride (32 apart: one lane, one and
    # several chunks of 128) and of another 31 and 33 apart (other lanes);
    # a neighbour that ties with them from half a pixel
    contour, proj, valid, inside = row(300, 700)
    for j in (32, 64, 96, 128, 256, 512):
        proj[j] = proj[0]
    for j in (31, 33, 65, 161):
        proj[j] = proj[1]
    proj[200] = proj[0] + [1.0, 0.0]
    contour[:8] = proj[[0, 1, 0, 1, 200, 31, 33, 0]]
    contour[8:12] = proj[[0, 0, 1, 1]] + [[0.5, 0.0], [0.0, 0.5],
                                          [0.5, 0.0], [0.0, 0.5]]
    cases["ties at the lane stride"] = (contour, proj, valid, inside)
    # the same row with invalid candidates, the first copies among them
    valid = (rng.random(700) > 0.3).astype(np.float32)
    valid[[0, 1, 31]] = 0.0
    valid[[32, 33, 64, 65, 96, 128, 161, 200, 256, 512]] = 1.0
    cases["ties among invalid candidates"] = (contour, proj, valid, inside)
    for M in (129, 2619):
        contour, proj, valid, inside = row(64, M)
        valid[:] = 0.0
        valid[-1] = 1.0
        cases[f"only the last of {M} valid"] = (contour, proj, valid, inside)
    cases["M 1"] = row(70, 1)
    cases["P 1"] = row(1, 2619)
    cases["P 1, M 1"] = row(1, 1)
    if card:
        contour, proj, valid, inside = row(300, 2619)
        contour[[3, 50]] = np.nan
        contour[60, 1] = np.nan
        proj[[5, 40, 41]] = np.nan
        proj[42, 0] = np.inf
        proj[43] = -3e38
        contour[70:74] = proj[[5, 42, 43, 44]]
        valid[7] = np.nan
        cases["NaN points"] = (contour, proj, valid, inside)
        contour, proj, valid, inside = row(200, 70_000)
        proj[[40_000, 69_999]] = proj[[100, 3100]]
        valid = (rng.random(70_000) > 0.4).astype(np.float32)
        valid[[100, 3100, 40_000, 69_999]] = 1.0
        contour[:4] = proj[[100, 3100, 100, 3100]]
        cases["tiled, 70,000 candidates"] = (contour, proj, valid, inside)
    return cases


def scatter_edge_cases():
    """Single rows that probe the scatter kernel's design, as numpy
    ``(idx [P] int32, g [P, 2], M)`` by name: all entries on one output,
    negative and out-of-range indices, P = 1 and M = 1, and rows longer
    than one block's chunk of 1,024 entries with runs across chunks."""
    rng = np.random.default_rng(8)

    def g(P):
        return rng.normal(size=(P, 2)).astype(np.float32)

    cases = {"3001 entries on one output": (
        np.full(3001, 7, np.int32), g(3001), 2619)}
    cases["negative and out-of-range"] = (
        rng.integers(-50, 150, size=700).astype(np.int32), g(700), 100)
    cases["P 1"] = (np.array([3], np.int32), g(1), 5)
    cases["M 1"] = (rng.integers(-1, 2, size=40).astype(np.int32), g(40), 1)
    idx = rng.integers(0, 300, size=2500).astype(np.int32)
    idx[1000:1100] = 11                       # a run across a chunk edge
    cases["2500 entries, 3 chunks"] = (idx, g(2500), 300)
    return cases


def bilinear_edge_cases():
    """Images and points that probe the sampler's design, as numpy
    ``(img [BV, H, W] float32 0/1, xy [BV, N, 2] float32)`` by name: NaN,
    infinite and +-1e9 coordinates, exact integers, points on each border
    of the image and in (-1, 0) and (W - 1, W), H or W of 1, and point
    counts that leave a block or a view half full (odd N, views smaller
    than a warp, 1,025 points)."""
    rng = np.random.default_rng(9)

    def case(BV, H, W, N):
        img = (rng.random((BV, H, W)) > 0.5).astype(np.float32)
        xy = rng.uniform(-3, [W + 2, H + 2], size=(BV, N, 2))
        return img, xy.astype(np.float32)

    img, xy = case(3, 40, 300, 1001)
    H, W = 40, 300
    special = []
    for x in (-1.0, -0.5, -1e-6, 0.0, 0.25, 1.0, 7.0, W - 1.0, W - 0.5,
              W - 1e-4, float(W)):
        for y in (-1.0, -0.25, 0.0, 3.0, H - 1.0, H - 0.5, float(H)):
            special.append((x, y))
    special += [(np.nan, 3.0), (3.0, np.nan), (np.nan, np.nan),
                (np.inf, 3.0), (3.0, -np.inf), (1e9, 5.0), (-1e9, 5.0),
                (5.0, 1e9), (5.0, -1e9), (-3e38, -3e38), (3e38, 2.0)]
    xy[:, :len(special)] = np.array(special, np.float32)
    xy[:, 200:260] = np.round(xy[:, 200:260])      # exact integers
    cases = {"borders, integers, NaN and far points (N 1001)": (img, xy)}
    cases["H 1"] = case(2, 1, 37, 333)
    cases["W 1"] = case(2, 29, 1, 257)
    img, xy = case(2, 1, 1, 9)
    xy[:, :4] = [[0.0, 0.0], [-0.5, 0.0], [0.0, -0.5], [0.5, 0.5]]
    cases["H 1, W 1"] = (img, xy)
    cases["N 1, 5 views"] = case(5, 16, 24, 1)
    cases["N 3, 7 views (vectors across views)"] = case(7, 16, 24, 3)
    cases["1,025 points, one view"] = case(1, 64, 128, 1025)
    cases["N 512 (aligned rows)"] = case(4, 48, 64, 512)
    return cases


def touched_taps(img, xy):
    """``(near, taps)`` of a bilinear sample of ``img [BV, H, W]`` at
    ``xy [BV, N, 2]``: the points whose 4 taps reach the image, and the
    distinct in-image pixels those taps read."""
    import torch

    BV, H, W = img.shape
    x, y = xy[..., 0], xy[..., 1]
    near = (x > -1) & (x < W) & (y > -1) & (y < H)      # NaN is not near
    x0 = torch.where(near, x, 0.0).floor().long()[near]
    y0 = torch.where(near, y, 0.0).floor().long()[near]
    bv = torch.arange(BV, device=xy.device)[:, None].expand_as(near)[near]
    ids = []
    for dy in (0, 1):
        for dx in (0, 1):
            tx, ty = x0 + dx, y0 + dy
            ok = (tx >= 0) & (tx < W) & (ty >= 0) & (ty < H)
            ids.append(((bv * H + ty) * W + tx)[ok])
    return int(near.sum()), int(torch.unique(torch.cat(ids)).numel())


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_device():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(1)
    if not os.path.isdir(os.path.join(REPO, "bodyfitting_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(bodyfitting_torch/ is missing)", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    # plain f32 everywhere: no TF32 in matmuls or convolutions (phase 11
    # runs the OpenPose convolutions under PyTorch's default, kept here)
    global CUDNN_TF32_DEFAULT
    CUDNN_TF32_DEFAULT = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    return smi


def phase_build():
    from bodyfitting_torch.ops.kernels import _build

    secs = _build.build_all()
    log(f"build: {len(_build.SOURCES)} kernels in {secs:.2f} s")
    for name, out in _build.build_log.items():
        regs = [ln.strip() for ln in out.splitlines()
                if "Used" in ln or "spill" in ln]
        log(f"  {name}: " + " | ".join(regs))


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def steps_ms(step, steps, device):
    """Host-clock ms per ``step(i)`` over ``steps``, the device drained at
    both ends."""
    sync(device)
    t = time.perf_counter()
    for i in steps:
        step(i)
    sync(device)
    return (time.perf_counter() - t) / len(steps) * 1e3


def phase_main_path(profile: bool, size=MAIN_PATH, device="cuda"):
    import torch

    from bodyfitting_torch.fitting import body_fitting as bf
    from bodyfitting_torch.fitting import smplify
    from bodyfitting_torch.losses.priors import synthetic_gmm_prior
    from bodyfitting_torch.models import body_model as bm
    from bodyfitting_torch.ops import kernels as K

    on_card = torch.device(device).type == "cuda"
    B, V = size["n_frames"], size["num_verts"]
    t0 = time.perf_counter()
    model = bm.synthetic_model("smplx", num_verts=V, seed=0, device=device)
    prior = synthetic_gmm_prior(device=device)
    obs_list, init_list, crop_hw = make_problem(
        model, B, size["n_views"], size["n_mask_views"], size["imsize"],
        size["focal"], size["dist"], size["contour_points"], seed=0,
        device=device)
    config = smplify.FitConfig(use_mask=True, num_iters=size["num_iters"],
                               imsize=float(size["imsize"]))
    gate = config.num_iters // config.stage_gate_den
    P = obs_list[0].contours.shape[2]
    log(f"main path set-up: {time.perf_counter() - t0:.1f} s; frames {B}, "
        f"vertices {V}, keypoint views {size['n_views']}, mask views "
        f"{size['n_mask_views']} at {size['imsize']}^2, crop {crop_hw}, "
        f"contour points {P}, iterations {config.num_iters}, gate {gate}")
    assert P == size["contour_points"], P

    sync(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    params, result, losses = bf.fit_frames_batched(
        model, config, obs_list, init_list, prior)
    sync(device)
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    peak = (f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB"
            if on_card else "not measured")
    log(f"main path fit: {wall:.3f} s wall for {config.num_iters} "
        f"iterations x {B} frames; peak device memory {peak}; "
        f"launches {launches}")

    losses = losses.cpu().numpy()
    digest = hashlib.sha1(np.ascontiguousarray(losses).tobytes()).hexdigest()
    log(f"main path loss trace {losses.shape} {losses.dtype}: sha1 {digest}")
    assert np.isfinite(losses).all(), "non-finite loss"
    assert result["vertices"].shape == (B, V, 3)
    assert torch.isfinite(result["vertices"]).all()
    post = losses[:, gate + 1:]
    log("loss per frame at step 0 / the gate / first masked step / "
        "post-gate peak / final / mean of the first and of the last 50 "
        "masked steps: " + "; ".join(
            "/".join(f"{v:.0f}" for v in row) for row in zip(
                losses[:, 0], losses[:, gate], post[:, 0], post.max(1),
                post[:, -1], post[:, :50].mean(1), post[:, -50:].mean(1))))
    # The mask term is live after the gate, and the masked stage descends
    # from its peak: its last 50 steps average at least 10 % below it.
    # The final loss is not required to fall below the first masked
    # step's.  When the mask term switches on, Adam's second moments still
    # hold the small keypoint gradients, so the first masked steps kick
    # the scale and translation far out, and the fit settles above where
    # the masked stage started.  The JAX package does the same on this
    # problem (python -m tests.mask_fit_vs_jax runs both on the CPU).
    assert (losses[:, gate + 1] > losses[:, gate]).all(), "mask term not live"
    assert (post[:, -50:].mean(1) < 0.9 * post.max(1)).all(), \
        "the masked stage did not descend from its peak"
    if on_card:
        for name in KERNEL_NAMES:
            assert launches[name] > 0, f"{name} never launched on the main path"

    obs = smplify.concat_frames(obs_list)
    init = smplify.concat_frames(init_list)
    models = smplify.loss_models(model, config)

    # step time before and after the gate, on a fresh copy of the start
    fresh = smplify.FitParams.from_tensors(
        [p.clone() for p in init.tensors()])
    opt = smplify.make_optimizer(config, fresh)
    step_fn = smplify.make_step_fn(model, config, obs, prior, opt)

    n = max(min(40, gate - 3), 1)
    steps_ms(step_fn, range(0, 3), device)
    pre = steps_ms(step_fn, range(3, 3 + n), device)
    steps_ms(step_fn, range(gate + 1, gate + 4), device)
    post = steps_ms(step_fn, range(gate + 4, gate + 4 + n), device)
    log(f"step time: {pre:.3f} ms/iteration before the gate, {post:.3f} "
        f"ms/iteration after it ({n} steps each, host clock)")
    if profile:
        profile_steps(step_fn, range(gate + 4 + n, gate + 24 + n))
    return dict(model=model, prior=prior, obs=obs, init=init, params=params,
                losses=losses, config=config, models=models,
                launches=launches, wall=wall, pre_ms=pre, post_ms=post,
                digest=digest)


def traced(run, n):
    """``run()`` under torch.profiler, per unit of ``n`` (steps or calls):
    host-clock ``wall_ms``, device ``busy_ms`` (the sum of its kernels'
    and copies' device time, gaps excluded), ``calls`` (kernels and
    copies) and ``by_name`` {kernel: (launches, device us)}, with the
    events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in events)
    return dict(wall_ms=wall * 1e3 / n, busy_ms=dev_us / 1e3 / n,
                calls=sum(e.count for e in events) / n,
                by_name={e.key: (e.count / n, e.self_device_time_total / n)
                         for e in events}, events=events)


def profile_steps(step_fn, steps, what="post-gate steps"):
    n = len(steps)
    r = traced(lambda: [step_fn(i) for i in steps], n)
    log(f"profile: {n} {what}, {r['wall_ms'] * n:.1f} ms wall, "
        f"device busy {r['busy_ms'] * n:.1f} ms "
        f"({100 * r['busy_ms'] / r['wall_ms']:.1f} %), {r['calls']:.0f} "
        f"device kernels and copies a step")
    for e in sorted(r["events"], key=lambda e: -e.self_device_time_total)[:15]:
        log(f"  {e.self_device_time_total / n:9.1f} us/step "
            f"{e.count // n:5d} calls/step  {e.key[:90]}")
    return r


def phase_checks(state, devices=("cuda", "cpu")):
    """Kernels against plain versions inside the fit loss, and the card
    against the CPU on a small fit."""
    import torch

    from bodyfitting_torch.fitting import body_fitting as bf
    from bodyfitting_torch.fitting import smplify
    from bodyfitting_torch.losses.priors import synthetic_gmm_prior
    from bodyfitting_torch.models import body_model as bm

    cfg, step = state["config"], state["config"].num_iters - 1
    args = (state["models"], cfg, state["params"], state["obs"],
            state["prior"], step)
    lk, gk = loss_and_grads(*args)
    with silhouette_ops(plain_versions):
        lp, gp = loss_and_grads(*args)
    loss_err = float(((lk - lp).abs() / lp.abs()).max())
    top = max(float(g.abs().max()) for g in gp)
    grad_err = max(float((a - b).abs().max()) for a, b in zip(gk, gp)) / top
    log(f"check: fit loss at the final state, kernels vs plain on the card: "
        f"max rel err {loss_err:.3e} (tol 1e-5); gradient max err "
        f"{grad_err:.3e} of the largest entry (tol 1e-5)")
    assert loss_err <= 1e-5 and grad_err <= 1e-5

    # a small fit on the card (kernels) and on the CPU (plain versions)
    small_cfg = smplify.FitConfig(num_iters=30, use_mask=True, imsize=128.0)
    traces = []
    for dev in devices:
        model = bm.synthetic_model("smplx", num_verts=512, seed=1, device=dev)
        prior = synthetic_gmm_prior(device=dev)
        obs_list, init_list, _ = make_problem(
            model, n_frames=2, n_views=4, n_mask_views=2, imsize=128,
            focal=230.0, dist=2.0, contour_points=64, seed=1, device=dev)
        _, _, tr = bf.fit_frames_batched(model, small_cfg, obs_list,
                                         init_list, prior)
        traces.append(tr.cpu().numpy())
    rel = float(np.max(np.abs(traces[0] - traces[1]) / np.abs(traces[1])))
    log(f"check: 30-step small fit, card (kernels) vs CPU (plain): loss "
        f"trace max rel err {rel:.3e} (tol 1e-3, f32 trajectories drift)")
    assert np.isfinite(traces[0]).all() and rel <= 1e-3


def capture_kernel_inputs(state):
    """The arguments the main path hands each kernel at its final state
    (one fit-loss evaluation and its backward, recorded)."""
    calls = {n: [] for n in KERNEL_NAMES}

    def record(name, fn):
        def wrapped(*a, **kw):
            calls[name].append((a, kw))
            return fn(*a, **kw)
        return wrapped

    cfg = state["config"]
    with silhouette_ops(record):
        loss_and_grads(state["models"], cfg, state["params"], state["obs"],
                       state["prior"], cfg.num_iters - 1)
    return calls


def phase_kernels(state):
    calls = capture_kernel_inputs(state)
    rows = []

    # --- bilinear_cov_grads: the stay-inside sample (with_grads) and the
    # matched-pixel lookup (value only) on the bit-mask crops the fit's
    # step reads; the full-mask mode (with_cov) on the stay-inside positions
    rows.append(check_bilinear(calls["bilinear_cov_grads"]))

    ((cargs, _),) = calls["contour_match_full"]
    rows.append(check_contour(cargs, edge_cases=True))
    ((sargs, _),) = calls["rows_scatter_add"]
    rows.append(check_scatter(sargs, edge_cases=True))

    table = []
    for r in rows:
        table.append(dict(
            name=r["name"], route="cuda", source=SOURCES[r["name"]],
            replaces=TPU_KERNELS[r["name"]],
            launches=state["launches"][r["name"]],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"],
            **{k: r[k] for k in ("shape", "shapes") if k in r},
        ))
    return table


def check_contour(cargs, edge_cases):
    """``contour_match_full`` (and ``contour_min_idx`` on the same kernel)
    bitwise its plain version at the captured arguments ``cargs`` and,
    with ``edge_cases``, on :func:`match_edge_cases`; its geometry and its
    time beside the plain version, ``cdist`` + ``argmin`` and the bound."""
    import torch

    from bodyfitting_torch.ops import kernels as K
    from bodyfitting_torch.ops.kernels import contour_match

    contour, proj, valid, inside = cargs
    BV = contour.shape[0]
    cases = {"captured": cargs}
    if edge_cases:
        cases.update({k: [torch.as_tensor(a[None], device=contour.device)
                          for a in arrays]
                      for k, arrays in match_edge_cases(card=True).items()})
    for what, args in cases.items():
        got = K.contour_match_full(*args)
        ref = K.contour_match_full_plain(*args)
        d2m, idxm = K.contour_min_idx(*args[:3])
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, ref))
        same_min = torch.equal(idxm, ref[1]) and torch.equal(d2m, ref[0])
        log(f"contour_match_full {what} (BV {args[0].shape[0]}, P "
            f"{args[0].shape[1]}, M {args[1].shape[1]}): d2, idx, matched, "
            f"in_match bitwise equal to plain: {same}; contour_min_idx: "
            f"{same_min} (tol: exact)")
        assert same and same_min, f"contour_match_full differs ({what})"
        if what == "captured":
            err = max(float((a.float() - b.float()).abs().max())
                      for a, b in zip(got, ref))
    _, P, _ = contour.shape
    M = proj.shape[1]
    geo = contour_match.launch_geometry(BV, P, M)
    share = float((valid > 0).float().mean())
    log(f"contour_match_full launch: {geo}; valid share of candidates "
        f"{share:.4f} ({int((valid > 0).sum())} of {valid.numel()})")
    ms = cuda_ms(lambda: K.contour_match_full(*cargs))
    plain = cuda_ms(lambda: K.contour_match_full_plain(*cargs), reps=10)
    lib = cuda_ms(lambda: torch.cdist(contour, proj).argmin(-1), reps=10)
    host = host_ms(lambda: K.contour_match_full(*cargs))
    out_bytes = BV * P * (4 + 4 + 8 + 4)
    # per (p, m): 2 subtractions, 2 products, 2 additions, 1 comparison
    b, by = bound_ms(nbytes(*cargs) + out_bytes, 7 * BV * P * M)
    log(f"contour_match_full: {ms:.4f} ms, plain {plain:.4f} ms, "
        f"cdist+argmin {lib:.4f} ms, bound {b:.4f} ms ({by}); "
        f"{host:.4f} ms per call on the host clock")
    return dict(name="contour_match_full", max_abs_err=err, ms=ms,
                plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib,
                shape=f"BV {BV} P {P} M {M}")


def check_scatter(sargs, edge_cases):
    """``rows_scatter_add`` at the captured arguments ``sargs`` and, with
    ``edge_cases``, on :func:`scatter_edge_cases`: two launches bitwise
    each other and the ascending-p plain version; its geometry and its
    time beside the plain version, ``index_add_`` and the bound."""
    import torch

    from bodyfitting_torch.ops import kernels as K
    from bodyfitting_torch.ops.kernels import rows_scatter

    idx, g, Mc = sargs
    BV = idx.shape[0]
    cases = {"captured": sargs}
    for k, (i, gg, m) in (scatter_edge_cases() if edge_cases
                          else {}).items():
        cases[k] = (torch.as_tensor(np.stack([i, i[::-1].copy()]),
                                    device=idx.device),
                    torch.as_tensor(np.stack([gg, gg[::-1].copy()]),
                                    device=idx.device), m)
    for what, args in cases.items():
        r1 = K.rows_scatter_add(*args)
        r2 = K.rows_scatter_add(*args)
        ref = K.rows_scatter_add_plain(*args)
        torch.cuda.synchronize()
        repeat, same = torch.equal(r1, r2), torch.equal(r1, ref)
        log(f"rows_scatter_add {what} (BV {args[0].shape[0]}, P "
            f"{args[0].shape[1]}, M {args[2]}): two launches bitwise equal: "
            f"{repeat}; bitwise equal to the ascending-p plain version: "
            f"{same} (tol: exact)")
        assert repeat and same, f"rows_scatter_add differs ({what})"
        if what == "captured":
            err = float((r1 - ref).abs().max())
    C = g.shape[2]
    keep = (idx >= 0) & (idx < Mc)
    flat = torch.where(
        keep, idx.long() + Mc * torch.arange(BV, device=idx.device)[:, None],
        BV * Mc).reshape(-1)
    runs = torch.unique(flat[flat < BV * Mc], return_counts=True)[1]
    geo = rows_scatter.launch_geometry(BV, idx.shape[1], Mc)
    log(f"rows_scatter_add launch: {geo}; {int(keep.sum())} of "
        f"{keep.numel()} entries in range, {runs.numel()} distinct outputs, "
        f"longest run of one idx {int(runs.max()) if runs.numel() else 0}")
    ms = cuda_ms(lambda: K.rows_scatter_add(idx, g, Mc))
    plain = cuda_ms(lambda: K.rows_scatter_add_plain(idx, g, Mc), reps=10)
    host = host_ms(lambda: K.rows_scatter_add(idx, g, Mc))
    gflat = g.reshape(-1, C)
    acc = torch.zeros((BV * Mc + 1, C), device=g.device)
    lib = cuda_ms(lambda: acc.index_add_(0, flat, gflat))
    b, by = bound_ms(nbytes(idx, g) + BV * C * Mc * 4,
                     C * int(keep.sum()))
    log(f"rows_scatter_add: {ms:.4f} ms, plain {plain:.4f} ms, index_add_ "
        f"{lib:.4f} ms, bound {b:.4f} ms ({by}); {host:.4f} ms per call on "
        f"the host clock")
    return dict(name="rows_scatter_add", max_abs_err=err, ms=ms,
                plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib,
                shape=f"BV {BV} P {idx.shape[1]} M {Mc}")


BILINEAR_MODES = (dict(with_grads=True, with_cov=False),    # stay inside
                  dict(with_grads=False, with_cov=False),   # lookup
                  dict(with_grads=True, with_cov=True))     # full masks


def bilinear_bound(img, xy):
    """``(bound ms, bound_by, bytes at a bit a pixel, near points,
    distinct taps)`` of one call: the bound counts the f32 contract's
    bytes (xy, the [BV, 6, N] output, 4 B per distinct in-image pixel a
    near point's taps touch) or 33 operations a near point (2 floors, 6
    weight ops, 9 for the sample, 16 for the two derivatives and their
    step factors); the same bytes with the pixels at a bit each are the
    bit-mask design's own count."""
    BV, N = xy.shape[:2]
    near, taps = touched_taps(img, xy)
    rest = nbytes(xy) + BV * 6 * N * 4
    b, by = bound_ms(4 * taps + rest, 33 * near)
    return b, by, -(-taps // 8) + rest, near, taps


def bilinear_images(img):
    """A 0/1 image ``[BV, H, W]`` in the sampler's two types: the bit mask
    (int32 words) and f32, each of width ``32 * ceil(W / 32)`` when
    ``img`` is a bit mask, else of width ``W`` (the bit mask's padding
    columns then read as zero pixels)."""
    import torch

    from bodyfitting_torch.ops.kernels import bilinear

    if img.dtype == torch.int32:
        return {"bits": img, "f32": bilinear.unpack_bits(img).float()}
    return {"bits": bilinear.pack_bits(img), "f32": img.float()}


def check_bilinear(calls):
    """The sampler at the main path's two calls: bitwise its plain
    version in its two image types and all three flag sets (the bit mask
    without coverage: it refuses with_cov), at the captured inputs and on
    :func:`bilinear_edge_cases`, the types bitwise each other; its
    geometry; warm and cold times beside the plain version,
    ``grid_sample`` and the bound."""
    import torch
    import torch.nn.functional as F

    from bodyfitting_torch.ops import kernels as K
    from bodyfitting_torch.ops.kernels import bilinear

    (look_args, look_kw), (stay_args, stay_kw) = calls
    assert not look_kw["with_grads"] and stay_kw["with_grads"]
    img, xy = stay_args
    assert (img.dtype == torch.int32
            and look_args[0].data_ptr() == img.data_ptr()), \
        "the fit's step should sample its one bit-mask copy of the crops"
    dev = xy.device
    cases = {"stay-inside": (img, stay_args[1]),
             "lookup": (img, look_args[1])}
    for what, (im, pts) in bilinear_edge_cases().items():
        cases[what] = (torch.as_tensor(im, device=dev),
                       torch.as_tensor(pts, device=dev))
    err = 0.0      # the largest |kernel - plain| at the captured calls
    for what, (im, pts) in cases.items():
        same = []
        for kw in BILINEAR_MODES:
            plain = {}
            for kind, image in bilinear_images(im).items():
                if kind == "bits" and kw["with_cov"]:
                    try:
                        K.bilinear_cov_grads(image, pts, **kw)
                    except ValueError:
                        continue
                    raise AssertionError("a bit mask sampled with_cov")
                got = K.bilinear_cov_grads(image, pts, **kw)
                plain[kind] = K.bilinear_cov_grads_plain(image, pts, **kw)
                torch.cuda.synchronize()
                same.append(torch.equal(got, plain[kind]))
                if what in ("stay-inside", "lookup") and kind == "bits":
                    err = max(err, float(
                        (got - plain[kind]).abs().max()))
            if "bits" in plain:
                same.append(torch.equal(plain["bits"], plain["f32"]))
        log(f"bilinear_cov_grads {what} (BV {im.shape[0]}, "
            f"{'x'.join(map(str, im.shape[1:]))} {im.dtype}, N "
            f"{pts.shape[1]}): bit mask and f32 x "
            f"{len(BILINEAR_MODES)} flag sets bitwise equal to plain, and "
            f"the types to each other: {all(same)} (tol: exact)")
        assert all(same), f"bilinear_cov_grads differs ({what})"

    shapes = []
    imgs = bilinear_images(img)
    BV, Hc, Wc = imgs["f32"].shape
    lib_img = imgs["f32"][:, None]
    for what, (args, kw) in (("stay-inside", (stay_args, stay_kw)),
                             ("lookup", (look_args, look_kw))):
        pts = args[1]
        N = pts.shape[1]
        geo = bilinear.kernel_geometry(BV, N)
        assert geo == bilinear.launch_geometry(BV, N), \
            f"bilinear geometry {geo} is not launch_geometry's"
        t = {}
        for kind, im in imgs.items():
            t[f"{kind}_ms"] = cuda_ms(
                lambda: K.bilinear_cov_grads(im, pts, **kw))
            t[f"{kind}_cold_ms"], t[f"{kind}_cold_mean_ms"] = cold_ms(
                lambda: K.bilinear_cov_grads(im, pts, **kw))
        plain = cuda_ms(lambda: K.bilinear_cov_grads_plain(img, pts, **kw),
                        reps=10)
        scale = torch.tensor([2.0 / (Wc - 1), 2.0 / (Hc - 1)], device=dev)
        grid = (pts * scale - 1.0)[:, None]                # [BV, 1, N, 2]
        lib = cuda_ms(lambda: F.grid_sample(
            lib_img, grid, mode="bilinear", padding_mode="zeros",
            align_corners=True))
        host = host_ms(lambda: K.bilinear_cov_grads(img, pts, **kw))
        b, by, bit_bytes, near, taps = bilinear_bound(imgs["f32"], pts)
        log(f"bilinear_cov_grads {what} (BV {BV}, N {N}, crops {Hc}x{Wc}) "
            f"launch {geo}: " + "; ".join(
                f"{kind} {t[kind + '_ms']:.5f} ms warm, "
                f"{t[kind + '_cold_ms']:.5f} cold (median of 200, mean "
                f"{t[kind + '_cold_mean_ms']:.5f})" for kind in imgs)
            + f"; plain {plain:.4f} ms, grid_sample (sample only, f32) "
            f"{lib:.5f} ms, bound {b:.5f} ms ({by}; the bit mask's own "
            f"bytes {bit_bytes}, {bit_bytes / HBM_BYTES_PER_S * 1e3:.5f} "
            f"ms); "
            f"{near} of {BV * N} points near the crop, {taps} distinct "
            f"pixels touched of {BV * Hc * Wc}; {host:.4f} ms per call on "
            f"the host clock")
        shapes.append(dict(what=what, BV=BV, N=N, ms=t["bits_ms"],
                           cold_ms=t["bits_cold_ms"], f32_ms=t["f32_ms"],
                           f32_cold_ms=t["f32_cold_ms"], plain_ms=plain,
                           library_ms=lib, bound_ms=b, bound_by=by))
    head = shapes[0]
    return dict(name="bilinear_cov_grads", max_abs_err=err, ms=head["ms"],
                plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
                bound_by=head["bound_by"], library_ms=head["library_ms"],
                shape=f"stay-inside BV {BV} N {head['N']}", shapes=shapes)


def check_bilinear_full(calls, where="rp app (c)"):
    """The sampler at the two calls a full-mask fit step makes (the
    RenderPeople app's ``--use_mask``): f32 masks ``[BV, H, W]``, the
    stay-inside sample with coverage and derivatives, and the
    matched-pixel lookup.  Each bitwise its plain version; warm and cold
    times beside the plain version, ``grid_sample`` and the bound."""
    import torch
    import torch.nn.functional as F

    from bodyfitting_torch.ops import kernels as K
    from bodyfitting_torch.ops.kernels import bilinear

    shapes = []
    for what in ("stay-inside", "lookup"):
        (img, pts), kw = calls[what]
        assert img.dtype == torch.float32 and kw["with_cov"] == (
            what == "stay-inside"), (what, img.dtype, kw)
        got = K.bilinear_cov_grads(img, pts, **kw)
        ref = K.bilinear_cov_grads_plain(img, pts, **kw)
        torch.cuda.synchronize()
        same = torch.equal(got, ref)
        BV, H, W = img.shape
        N = pts.shape[1]
        log(f"bilinear_cov_grads {where} {what} (BV {BV}, {H}x{W} f32 "
            f"full masks, N {N}, {kw}): bitwise equal to plain: {same} "
            f"(tol: exact)")
        assert same, f"bilinear_cov_grads differs ({where} {what})"
        err = float((got - ref).abs().max())
        geo = bilinear.kernel_geometry(BV, N)
        ms = cuda_ms(lambda: K.bilinear_cov_grads(img, pts, **kw))
        cold, cold_mean = cold_ms(lambda: K.bilinear_cov_grads(img, pts,
                                                               **kw))
        plain = cuda_ms(lambda: K.bilinear_cov_grads_plain(img, pts, **kw),
                        reps=10)
        scale = torch.tensor([2.0 / (W - 1), 2.0 / (H - 1)],
                             device=pts.device)
        grid = (pts * scale - 1.0)[:, None]                # [BV, 1, N, 2]
        lib = cuda_ms(lambda: F.grid_sample(
            img[:, None], grid, mode="bilinear", padding_mode="zeros",
            align_corners=True))
        b, by, _, near, taps = bilinear_bound(img, pts)
        log(f"bilinear_cov_grads {where} {what} launch {geo}: {ms:.5f} "
            f"ms warm, {cold:.5f} cold (median of 200, mean "
            f"{cold_mean:.5f}); plain {plain:.4f} ms, grid_sample (sample "
            f"only) {lib:.5f} ms, bound {b:.5f} ms ({by}); {near} of "
            f"{BV * N} points near the image, {taps} distinct pixels "
            f"touched of {BV * H * W}")
        shapes.append(dict(what=what, BV=BV, N=N, H=H, W=W, max_abs_err=err,
                           ms=ms, cold_ms=cold, plain_ms=plain,
                           library_ms=lib, bound_ms=b, bound_by=by))
    head = shapes[0]
    return dict(name="bilinear_cov_grads",
                max_abs_err=max(r["max_abs_err"] for r in shapes),
                **{k: head[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")},
                shape=f"stay-inside with_cov BV {head['BV']} N {head['N']} "
                f"{head['H']}x{head['W']} f32", shapes=shapes)


# ---------------------------------------------------------------------------
# The scan path: RenderPeople's SMPLify + SMPL+D fit
# ---------------------------------------------------------------------------

# per query-face pair that is evaluated, the operations the distance cannot
# do without: 9 differences p - a/b/c, six 3-dots (30), va/vb/vc (9),
# d4 - d3 and d5 - d6 (2), and the squared distance to the closest point
# (8); the region's candidate point is left out
NEAREST_OPS_PER_PAIR = 58


def box_survivors(pts, tri, d2, tie_verts, chunk=512):
    """The query-face pairs that the function needs evaluated on this data:
    those whose face's bounding box lies within the query's tie band
    (``tie_threshold`` of its minimum ``d2``).  Every other pair is ruled
    out by its box alone, so an exact query that culls with per-face
    boxes (the TPU kernel culls with boxes of face blocks, coarser) need
    not compute its distance."""
    import torch

    from bodyfitting_torch.ops.kernels.nearest import tie_threshold

    lo, hi = tri.amin(dim=1), tri.amax(dim=1)              # [F, 3]
    thr = tie_threshold(d2, tie_verts)
    n = 0
    for s in range(0, pts.shape[0], chunk):
        p = pts[s:s + chunk, None]                          # [c, 1, 3]
        e = torch.clamp(lo - p, min=0) + torch.clamp(p - hi, min=0)
        n += int(((e * e).sum(-1) <= thr[s:s + chunk, None]).sum())
    return n


@contextlib.contextmanager
def nearest_ops(replace):
    """Temporarily replace the nearest-point kernel entry point where the
    scan path calls it (the volume build and the exact query)."""
    from bodyfitting_torch.ops import nearest as near
    from bodyfitting_torch.ops import sdf

    orig = near.nearest_d2_idx
    for mod in (near, sdf):
        mod.nearest_d2_idx = replace(orig)
    try:
        yield
    finally:
        for mod in (near, sdf):
            mod.nearest_d2_idx = orig


def recorder(calls):
    def replace(fn):
        def wrapped(*a, **kw):
            calls.append((a, kw))
            return fn(*a, **kw)
        return wrapped
    return replace


def check_nearest(args, kw, what):
    """The kernel against its plain version on one call's inputs: ``d2``
    bitwise, ``idx`` exactly; returns the max abs error of ``d2``."""
    import torch

    from bodyfitting_torch.ops import kernels as K

    d2, idx = K.nearest_d2_idx(*args, **kw)
    d2p, idxp = K.nearest_d2_idx_plain(*args, **kw)
    sync(d2.device)
    err = float((d2 - d2p).abs().max())
    ok = torch.equal(d2, d2p) and torch.equal(idx, idxp)
    log(f"nearest_d2_idx {what}: Q {args[0].shape[0]} F {args[1].shape[0]}: "
        f"d2 bitwise equal {torch.equal(d2, d2p)}, idx equal "
        f"{torch.equal(idx, idxp)} (tol: exact); max abs err {err:.3e}")
    assert ok, f"nearest_d2_idx differs from its plain version ({what})"
    return err


def scan_step_times(model, config, obs, prior, init, body_vertices, device,
                    n, profile=False):
    """Host-clock ms per body step before and after the gate, and per
    displacement step, each over ``n`` steps from a fresh start; with
    ``profile``, 20 more of each kind after the gate traced."""
    from bodyfitting_torch.fitting import smplify

    gate = config.num_iters // config.stage_gate_den
    fresh = smplify.FitParams.from_tensors([t.clone() for t in init.tensors()])
    opt = smplify.make_optimizer(config, fresh)
    step_fn = smplify.make_step_fn(model, config, obs, prior, opt)
    steps_ms(step_fn, range(0, 2), device)
    pre = steps_ms(step_fn, range(2, 2 + n), device)
    steps_ms(step_fn, range(gate + 1, gate + 3), device)
    post = steps_ms(step_fn, range(gate + 3, gate + 3 + n), device)
    if profile:
        profile_steps(step_fn, range(gate + 3 + n, gate + 23 + n),
                      "SDF post-gate steps")
    disp_loss, dopt, disp = smplify.displacement_problem(
        model, config, obs, body_vertices[None])

    def disp_step(_):
        import torch

        disp.requires_grad_(True)
        (g,) = torch.autograd.grad(disp_loss(disp).sum(), [disp])
        disp.requires_grad_(False)
        dopt.step([g])

    steps_ms(disp_step, range(2), device)
    dstep = steps_ms(disp_step, range(n), device)
    if profile:
        profile_steps(disp_step, range(20), "SDF displacement steps")
    return pre, post, dstep


def phase_scan(size=SCAN_PATH, device="cuda", n_time=40, smi="",
               profile=False, save_volume=None):
    """The scan path through the port's entry points: the volume build and
    the SDF fit (the default route), then the exact route.  With
    ``save_volume`` (a path), the scan problem, its volume and the SDF
    fit's result are written there as one ``.npz`` for
    ``tests/scan_fit_vs_jax.py``."""
    import torch

    from bodyfitting_torch.fitting import body_fitting as bf
    from bodyfitting_torch.fitting import smplify
    from bodyfitting_torch.losses.priors import synthetic_gmm_prior
    from bodyfitting_torch.models import body_model as bm
    from bodyfitting_torch.ops import kernels as K

    on_card = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    model = bm.spin_joint_mapper_for_smpl(bm.synthetic_model(
        "smpl", num_verts=size["num_verts"], mesh="sphere", seed=0,
        device=device))
    prior = synthetic_gmm_prior(device=device)
    c2ws, Ks, kps, sv, sf = make_scan_problem(
        model, size["n_views"], size["imsize"], size["subdivisions"], seed=0)
    V = model.num_verts
    log(f"scan problem: {time.perf_counter() - t0:.1f} s; SMPL {V} vertices "
        f"{model.faces.shape[0]} faces; scan {len(sv)} vertices {len(sf)} "
        f"faces, height {np.ptp(sv[:, 1]):.3f}; {size['n_views']} keypoint "
        f"views at {size['imsize']}^2")
    config = smplify.FitConfig(use_mesh=True, displacement=True,
                               num_iters=size["num_iters"],
                               imsize=float(size["imsize"]))
    gate = config.num_iters // config.stage_gate_den
    R = size["sdf_resolution"]
    n_chunks = -(-R ** 3 // 65536)

    # --- main path, SDF route: the volume build, then the fit
    calls = []
    sync(device)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with nearest_ops(recorder(calls)):
        obs = bf.build_observations(
            c2ws, Ks, kps, use_hand_face=False, scan_verts=sv, scan_faces=sf,
            sdf_resolution=R, device=device)
    sync(device)
    build_s = time.perf_counter() - t0
    betas, poses = bf.hmr_init(None, c2ws[0])
    init = bf.init_params_from_hmr(model, betas, poses)
    t0 = time.perf_counter()
    params, result, losses = bf.fit_scan(model, config, obs, init, prior)
    sync(device)
    fit_s = time.perf_counter() - t0
    launches = K.launch_counts()
    log(f"scan SDF path: volume {R}^3 in {len(calls)} chunks built in "
        f"{build_s:.3f} s; fit {config.num_iters} + {config.num_iters} "
        f"iterations in {fit_s:.3f} s wall; launches {launches}")
    assert len(calls) == n_chunks, len(calls)
    if on_card:
        assert launches["nearest_d2_idx"] == n_chunks, launches

    losses = losses.cpu().numpy()
    body, dtrace = losses[:config.num_iters], losses[config.num_iters:]
    assert np.isfinite(losses).all(), "non-finite loss"
    disp = result["displacement"]
    assert disp.shape == (V, 3) and torch.isfinite(disp).all()
    log(f"scan SDF fit: body vertices sha1 {tensor_sha1(result['vertices'])}"
        f", displacements sha1 {tensor_sha1(disp)} (the same on every run: "
        f"no sum of the fit depends on launch order)")
    models = smplify.loss_models(model, config)
    pc = [float(smplify.fit_loss(models[0], config, params, obs, s, prior,
                                 joints_model=models[1])[1]["pc_loss"][0])
          for s in (gate, gate + 1)]
    k = min(50, len(dtrace) // 3)
    log(f"scan SDF fit: loss at step 0 / the gate / final body step "
        f"{body[0]:.1f} / {body[gate]:.1f} / {body[-1]:.1f}; point-to-scan "
        f"term at the final state, step {gate} / {gate + 1}: {pc[0]:.4f} / "
        f"{pc[1]:.4f}; displacement loss, mean of the first / last {k} "
        f"steps {dtrace[:k].mean():.6f} / {dtrace[-k:].mean():.6f}; mean "
        f"|displacement| {float(disp.norm(dim=1).mean()) * 1e3:.2f} mm")
    assert pc[0] == 0.0 and pc[1] > 0.0, "point-to-scan term not live"
    assert dtrace[-k:].mean() < dtrace[:k].mean(), \
        "the displacement stage did not descend"
    # the SMPL+D surface lies closer to the scan than the body alone
    from bodyfitting_torch.ops.nearest import nearest_points

    def residual_mm(v):
        closest, _ = nearest_points(v, obs.scan_verts[0], obs.scan_faces[0])
        return float((v - closest).norm(dim=1).mean()) * 1e3

    r_body = residual_mm(result["vertices"])
    r_disp = residual_mm(result["vertices"] + disp)
    log(f"scan SDF fit: mean distance of the fitted vertices to the scan "
        f"{r_body:.2f} mm for the body, {r_disp:.2f} mm with the "
        f"displacements (exact query)")
    assert r_disp < r_body, "the displacements moved away from the scan"
    if save_volume:
        vol = obs.scan_volume
        np.savez(save_volume, c2ws=np.stack(c2ws), Ks=np.stack(Ks),
                 keypoints=np.stack([k["pose"] for k in kps]),
                 scan_verts=sv, scan_faces=sf.astype(np.int32),
                 **{f"vol.{k}": getattr(vol, k)[0].cpu().numpy()
                    for k in ("dist", "face_idx", "origin")},
                 **{"vol.spacing": vol.spacing[0].cpu().numpy(),
                    "fit.losses": losses, "fit.vertices":
                    result["vertices"].cpu().numpy(),
                    "fit.displacement": disp.cpu().numpy(),
                    "fit.residual_mm": np.array([r_body, r_disp]),
                    "size": np.array([size["num_verts"], size["imsize"]])})
        log(f"scan problem, volume and SDF fit saved to {save_volume}")
    chunk = calls[len(calls) // 2]
    chunk_err = check_nearest(*chunk, "volume chunk")
    sdf_ms = scan_step_times(model, config, obs, prior, init,
                             result["vertices"], device, n_time, profile)
    log(f"scan SDF step time on {smi}: {sdf_ms[0]:.3f} ms/iteration before "
        f"the gate, {sdf_ms[1]:.3f} after it, {sdf_ms[2]:.3f} per "
        f"displacement iteration ({n_time} steps each, host clock)")

    # --- the exact route at full width and cut depth
    ecfg = dataclasses.replace(config, mesh_loss_impl="exact",
                               num_iters=size["exact_iters"])
    egate = ecfg.num_iters // ecfg.stage_gate_den
    eobs = dataclasses.replace(obs, scan_volume=None)
    sync(device)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    eparams, eresult, elosses = bf.fit_scan(model, ecfg, eobs, init, prior)
    sync(device)
    exact_s = time.perf_counter() - t0
    elaunches = K.launch_counts()
    expect = (ecfg.num_iters - egate - 1) + ecfg.num_iters
    log(f"scan exact path: {ecfg.num_iters} + {ecfg.num_iters} iterations, "
        f"gate {egate}, in {exact_s:.3f} s wall; launches {elaunches} (one "
        f"per query, both passes; expected {expect})")
    assert np.isfinite(elosses.cpu().numpy()).all()
    if on_card:
        assert elaunches["nearest_d2_idx"] == expect, elaunches
    # loss and gradient at the final state, kernel vs plain, body and
    # displacement stages
    emodels = smplify.loss_models(model, ecfg)
    args = (emodels, ecfg, eparams, eobs, prior, ecfg.num_iters - 1)
    lk, gk = loss_and_grads(*args)
    with nearest_ops(lambda fn: K.nearest_d2_idx_plain):
        lp, gp = loss_and_grads(*args)
    body_loss_err = float(((lk - lp).abs() / lp.abs()).max())
    top = max(float(g.abs().max()) for g in gp if g.numel())
    body_grad_err = max(float((a - b).abs().max())
                        for a, b in zip(gk, gp) if a.numel()) / top
    disp_loss, _, _ = smplify.displacement_problem(
        model, ecfg, eobs, eresult["vertices"][None])
    dstate = eresult["displacement"][None]
    qcalls = []

    def disp_loss_grad():
        d = dstate.detach().clone().requires_grad_(True)
        loss = disp_loss(d).sum()
        (g,) = torch.autograd.grad(loss, [d])
        return loss.detach(), g

    with nearest_ops(recorder(qcalls)):
        dlk, dgk = disp_loss_grad()
    with nearest_ops(lambda fn: K.nearest_d2_idx_plain):
        dlp, dgp = disp_loss_grad()
    disp_loss_err = float((dlk - dlp).abs() / dlp.abs())
    disp_grad_err = float((dgk - dgp).abs().max() / dgp.abs().max())
    log(f"check: exact fit at its final state, kernel vs plain on the card: "
        f"body loss rel err {body_loss_err:.3e}, gradient {body_grad_err:.3e} "
        f"of the largest entry; displacement loss rel err "
        f"{disp_loss_err:.3e}, gradient {disp_grad_err:.3e} (tol 1e-5: the "
        f"queries agree exactly, the vertex normals sum with atomics)")
    assert max(body_loss_err, body_grad_err, disp_loss_err,
               disp_grad_err) <= 1e-5
    query_err = check_nearest(*qcalls[0], "in-fit query")
    return dict(launches=launches["nearest_d2_idx"],
                exact_launches=elaunches["nearest_d2_idx"],
                chunk=chunk, query=qcalls[0],
                max_abs_err=max(chunk_err, query_err),
                # what phase 12 (b) batches with a second scan
                batch_input=dict(
                    model=model, prior=prior, config=config, problem=(
                        c2ws, Ks, kps, sv, sf), fit_s=fit_s,
                    sdf_resolution=R, exact_iters=size["exact_iters"],
                    exact_s=exact_s, residual_mm=(r_body, r_disp),
                    vertices=result["vertices"], displacement=disp,
                    exact_vertices=eresult["vertices"]),
                texture_input=dict(
                    scan_verts=sv, scan_faces=sf,
                    smpl_faces=model.faces.cpu().numpy(),
                    vertices=result["vertices"].cpu().numpy(),
                    displacement=disp.cpu().numpy()))


def nearest_row(scan):
    """The kernel's timing at the volume chunk and the in-fit query.  The
    bound is what the function needs: its bytes, or the operations of the
    pairs that per-face bounding boxes cannot rule out
    (:func:`box_survivors`), whichever takes longer.  The all-pairs
    figure, the work of the port's brute-force sweep, is printed beside
    it."""
    from bodyfitting_torch.ops import kernels as K

    rows = {}
    for what, (args, kw), reps in (("volume chunk", scan["chunk"], 3),
                                   ("in-fit query", scan["query"], 10)):
        pts, tri = args[0], args[1]
        Q, F = pts.shape[0], tri.shape[0]
        ms = cuda_ms(lambda: K.nearest_d2_idx(*args, **kw), reps=reps,
                     warmup=1)
        plain = cuda_ms(lambda: K.nearest_d2_idx_plain(*args, **kw), reps=1,
                        warmup=0)
        d2, _ = K.nearest_d2_idx(*args, **kw)   # equal to the plain d2
        pairs = box_survivors(pts, tri, d2, kw["tie_verts"])
        # bytes: points, triangles, tie vertices in; d2 and idx out
        b, by = bound_ms(nbytes(*args, *kw.values()) + Q * 8,
                         NEAREST_OPS_PER_PAIR * pairs)
        brute = NEAREST_OPS_PER_PAIR * Q * F / F32_FLOPS_PER_S * 1e3
        log(f"nearest_d2_idx {what} Q {Q} F {F}: {ms:.3f} ms, plain "
            f"{plain:.3f} ms, bound {b:.5f} ms ({by}; {pairs} pairs that "
            f"face boxes cannot rule out, {pairs / Q:.2f} a query); "
            f"all-pairs (brute-force) operations bound {brute:.3f} ms; no "
            f"single PyTorch call computes point-triangle distance "
            f"(library: none)")
        rows[what] = dict(Q=Q, F=F, ms=ms, plain_ms=plain, bound_ms=b,
                          bound_by=by, box_pairs=pairs,
                          all_pairs_bound_ms=brute)
    main, fit = rows["volume chunk"], rows["in-fit query"]
    return dict(
        name="nearest_d2_idx", route="cuda",
        source=SOURCES["nearest_d2_idx"],
        replaces=TPU_KERNELS["nearest_d2_idx"],
        launches=scan["launches"], max_abs_err=scan["max_abs_err"],
        ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=None,
        shape=f"volume chunk Q {main['Q']} F {main['F']}",
        box_pairs=main["box_pairs"],
        all_pairs_bound_ms=main["all_pairs_bound_ms"],
        in_fit=dict(fit, launches=scan["exact_launches"]),
    )


# ---------------------------------------------------------------------------
# The texture stage: RenderPeople's scan-view renders and UV texture fit
# ---------------------------------------------------------------------------

# The texture stage's shape: RenderPeople's prep renders (--viewnum 8
# --load_size 512 --white_bkgd) and texfit task (TextureFitConfig()
# defaults: 1024^2 texture, 512^2 renders, 200 Adam iterations over 18
# ring views x 5 cycles, then sphere views; the --auto_uv atlas), of the
# scan phase's 219,008-face scan, textured with a 2048^2 atlas.
TEXTURE_PATH = dict(scan_tex_size=2048, viewnum=8, imgsize=512, fit={})

# per pixel-face pair whose face box holds the pixel centre: the 4 box
# comparisons, the 3 edge functions (2 differences, 2 products and a
# difference each) and the 6 sign tests of the inside test
RASTER_OPS_PER_PAIR = 25


def colour_field(verts, seed=0):
    """A smooth seeded RGB field over the vertices, in [0.15, 0.85]."""
    rng = np.random.default_rng(seed)
    freq = rng.uniform(3.0, 9.0, size=(3, 3))
    phase = rng.uniform(0.0, 2 * np.pi, size=3)
    return (0.5 + 0.35 * np.sin(verts @ freq.T + phase)).astype(np.float32)


def box_pairs(face_px, face_z, size):
    """The pixel-face pairs whose face's pixel box holds the pixel centre,
    over the faces that can win (front, corners finite)."""
    import torch

    live = (face_z > 1e-9).all(1) & torch.isfinite(face_px).all(2).all(1)
    lo = face_px[live].amin(1).double()
    hi = face_px[live].amax(1).double()
    first = torch.clamp(torch.ceil(lo - 0.5), min=0)
    last = torch.clamp(torch.floor(hi - 0.5), max=size - 1)
    n = torch.clamp(last - first + 1, min=0)
    return int((n[:, 0] * n[:, 1]).sum())


def check_raster(kind, args, size, what):
    """One kernel against its plain version on the same inputs: depth and
    attributes bitwise, face indices exactly.  Returns the plain version's
    ms (one call; device time on the card) and the max abs error."""
    import torch

    from bodyfitting_torch.ops import kernels as K

    got = getattr(K, kind)(*args, size)
    ref = []

    def run_plain():
        ref.append(getattr(K, f"{kind}_plain")(*args, size))

    if args[0].is_cuda:
        plain_ms = cuda_ms(run_plain, reps=1, warmup=0)
    else:
        plain_ms = steps_ms(lambda _: run_plain(), range(1), "cpu")
    ref = ref[0]
    same = all(torch.equal(a, b) for a, b in zip(got, ref))
    err = max(float((a.double() - b.double()).abs().max()) if a.numel()
              else 0.0 for a, b in zip(got, ref))
    log(f"{kind} {what}: F {args[0].shape[0]} at {size}^2, "
        f"{int((got[1] >= 0).sum())} pixels covered: depth"
        f"{', attributes' if len(got) == 3 else ''} bitwise and face_idx "
        f"exactly equal to the plain version: {same} (tol: exact)")
    assert same, f"{kind} differs from its plain version ({what})"
    return plain_ms, err


def phase_texture(scan, size=TEXTURE_PATH, device="cuda", smi="",
                  check_devices=("cuda", "cpu")):
    """The texture stage through the port's entry points, as the
    RenderPeople app's prep and ``run_texfit`` run it, on the scan phase's
    scan and SDF fit: the textured scan, its ring-view renders, the texture
    fit, and the atlas work after it (coverage, hole fill, unseen mask,
    diffusion and LBAM inpainting, displacement bake)."""
    import torch

    from bodyfitting_torch.fitting import texture as tf
    from bodyfitting_torch.models.inpaint import Inpainter
    from bodyfitting_torch.ops import kernels as K
    from bodyfitting_torch.ops import rasterize as rz
    from bodyfitting_torch.utils.uv_unwrap import per_face_atlas

    on_card = torch.device(device).type == "cuda"
    inp = scan["texture_input"]
    sv, sf = inp["scan_verts"], inp["scan_faces"]
    smpl_f = inp["smpl_faces"]
    verts = inp["vertices"] + inp["displacement"]
    config = tf.TextureFitConfig(**size["fit"])
    uvs, fu = per_face_atlas(len(sf))
    scan_face_uvs = uvs[fu]
    suv, sfu = per_face_atlas(len(smpl_f))
    smpl_face_uvs = suv[sfu]
    colours = colour_field(sv)
    center, _, dist = tf.scene_bounds(sv)
    poses = tf.training_pose_schedule(config, center, dist)
    uniq, index = np.unique(poses.reshape(len(poses), -1), axis=0,
                            return_inverse=True)
    n_uniq = len(uniq)
    times = {}

    sync(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t_stage = time.perf_counter()
    # 1. the textured scan: a 2048^2 atlas baked from the colour field
    tex_map, tex_cov = tf.bake_displacement_map(
        scan_face_uvs, sf, colours, size["scan_tex_size"], device=device)
    scan_tex = tex_map + 0.5 * (1.0 - tex_cov)[..., None]
    # 2. the prep's ring-view renders
    sync(device)
    t0 = time.perf_counter()
    imgs, masks, w2cs, Ks = tf.render_scan_views(
        sv, sf, scan_face_uvs, scan_tex, imgsize=size["imgsize"],
        viewnum=size["viewnum"], white_bkgd=True, device=device)
    times["views"] = time.perf_counter() - t0
    # 3. the texture fit (--auto_uv atlas, TextureFitConfig)
    sync(device)
    t0 = time.perf_counter()
    tex, losses = tf.fit_texture(verts, smpl_f, smpl_face_uvs, sv, sf,
                                 scan_face_uvs, scan_tex, config,
                                 device=device)
    sync(device)
    times["fit"] = time.perf_counter() - t0
    # 4. after the fit, as run_texfit
    t0 = time.perf_counter()
    uv_raster = tf.rasterize_uv_atlas(smpl_face_uvs, config.tex_img_size,
                                      device=device)
    coverage = rz.render_silhouette(uv_raster).cpu().numpy()
    img = tf.fill_texture_holes(tex.cpu().numpy(), coverage)
    grey = np.abs(img - 128.0 / 255.0).max(-1) < 0.04
    unseen = grey & (coverage > 0.5)
    times["atlas_fill"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    img_diffused = tf.inpaint_unseen(img, unseen, device=device)
    times["diffusion"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    net = Inpainter(seed=0, device=device)
    sync(device)
    times["lbam_weights"] = time.perf_counter() - t1
    img_lbam = net((img * 255).astype(np.uint8),
                   (unseen[..., None] * np.uint8(255)).repeat(3, -1))
    times["lbam"] = time.perf_counter() - t1
    dis_map, dis_cov = tf.bake_displacement_map(
        smpl_face_uvs, smpl_f, inp["displacement"], config.tex_img_size,
        raster=uv_raster, device=device)
    dis8 = tf.displacement_map_to8b(dis_map, dis_cov)
    sync(device)
    times["stage"] = time.perf_counter() - t_stage
    launches = K.launch_counts()
    peak = (f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB"
            if on_card else "not measured")

    log(f"texture stage: scan {len(sf)} faces, {size['scan_tex_size']}^2 "
        f"atlas; {size['viewnum']} views at {size['imgsize']}^2; fit of "
        f"{len(smpl_f)} SMPL faces, {config.iter_num} iterations, "
        f"{n_uniq} unique poses, {config.render_img_size}^2 renders, "
        f"{config.tex_img_size}^2 texture; launches {launches} "
        f"(rasterize_attrs expected {2 * n_uniq}, rasterize_zbuf "
        f"{size['viewnum'] + 2}); peak device memory {peak}")
    log(f"texture stage wall: scan views {times['views']:.3f} s, texture fit "
        f"{times['fit']:.3f} s, atlas raster + hole fill "
        f"{times['atlas_fill']:.3f} s, diffusion inpainting "
        f"{times['diffusion']:.3f} s, LBAM {times['lbam']:.3f} s (its "
        f"seeded weights {times['lbam_weights']:.3f} s), whole "
        f"stage {times['stage']:.3f} s (host clock, device drained; {smi})")
    if on_card:
        assert launches["rasterize_attrs"] == 2 * n_uniq, launches
        assert launches["rasterize_zbuf"] == size["viewnum"] + 2, launches

    # checks on the stage's outputs
    losses = losses.cpu().numpy()
    assert np.isfinite(losses).all(), "non-finite texture loss"
    assert imgs.shape == (size["viewnum"], size["imgsize"], size["imgsize"],
                          3) and imgs.dtype == np.uint8
    cover = (masks > 0).reshape(len(masks), -1).mean(1)
    log("scan-view mask coverage: " + " ".join(f"{c:.3f}" for c in cover))
    assert (cover > 0).all(), "a scan view has no coverage"
    for name, a in (("texture", img), ("diffused", img_diffused),
                    ("lbam", img_lbam), ("displacement map", dis8)):
        assert np.isfinite(a.astype(np.float64)).all(), name
    assert img_lbam.shape == img.shape == (config.tex_img_size,) * 2 + (3,)
    log(f"atlas coverage {coverage.mean():.3f}; unseen grey texels "
        f"{int(unseen.sum())}; mean |texture - grey| "
        f"{np.abs(img - 128 / 255).mean():.4f}")

    # the map build and the Adam loop timed apart, and the ring-view L1
    # of the grey and the fitted textures (outside the counted run)
    dev = torch.device(device)

    def t(x):
        return torch.as_tensor(x, device=dev)

    Kt = t(tf.default_K(config.render_img_size))
    scene = (t(sv), t(sf).long(), t(scan_face_uvs), scan_tex, t(verts),
             t(smpl_f).long(), t(smpl_face_uvs))
    sync(device)
    t0 = time.perf_counter()
    maps = tf.texture_maps(t(uniq.reshape(-1, 4, 4)), Kt, scene,
                           config.render_img_size)
    sync(device)
    times["maps"] = time.perf_counter() - t0
    grey_tex = torch.full_like(tex, 128.0 / 255.0)
    idx = [int(i) for i in np.asarray(index).reshape(-1)]
    t0 = time.perf_counter()
    tex2, _ = tf.adam_loop(config.lr, lambda t, k: tf.maps_loss(
        t, maps[0][k], maps[1][k], maps[2][k]), grey_tex, idx)
    sync(device)
    times["adam_ms"] = (time.perf_counter() - t0) / len(idx) * 1e3
    repeat = float((tex2 - tex).abs().max())
    ring = idx[:config.round_views]
    l1 = [sum(float(tf.maps_loss(t, maps[0][k], maps[1][k], maps[2][k]))
              for k in ring) for t in (grey_tex, tex)]
    log(f"texture fit parts: map build of {len(uniq)} poses {times['maps']:.3f}"
        f" s; Adam loop {times['adam_ms']:.3f} ms/iteration (host clock); "
        f"the fit's losses first/last {losses[0]:.1f}/{losses[-1]:.1f}; "
        f"ring-view L1 over {len(ring)} poses: grey {l1[0]:.1f}, fitted "
        f"{l1[1]:.1f}; the loop again on rebuilt maps: texture max abs "
        f"diff {repeat:.3e}")
    assert l1[1] < l1[0], "the fitted texture is no closer than grey"

    # kernels against plain versions on the stage's inputs
    rows = {}
    s_px, s_fz = rz.project_faces(scene[0], scene[1], t(w2cs[0]), t(Ks[0]))
    zargs = (s_px.contiguous(), s_fz.contiguous())
    rows["rasterize_zbuf"] = (zargs, size["imgsize"], *check_raster(
        "rasterize_zbuf", zargs, size["imgsize"], "scan view 0"),
        "scan view")
    w2c = t(uniq[0].reshape(4, 4))
    for what, (v, f, u) in (("SMPL", scene[4:7]), ("scan", scene[0:3])):
        px, fz = rz.project_faces(v, f, w2c, Kt)
        aargs = (px.contiguous(), fz.contiguous(), u.contiguous())
        rows["rasterize_attrs"] = (aargs, config.render_img_size,
                                   *check_raster("rasterize_attrs", aargs,
                                                 config.render_img_size,
                                                 f"{what} pose 0"),
                                   f"{what} pose")

    table = []
    for name, (args, isz, pms, err, what) in rows.items():
        kern = getattr(K, name)
        if on_card:
            ms = cuda_ms(lambda: kern(*args, isz), reps=20, warmup=2)
            wrap = cuda_ms(lambda: K.raster.work_items(args[0], args[1], isz,
                                                       isz), reps=20, warmup=2)
        else:
            ms = steps_ms(lambda _: kern(*args, isz), range(1), device)
            wrap = float("nan")
        pairs = box_pairs(args[0], args[1], isz)
        A = args[2].shape[2] if len(args) > 2 else 0
        out_bytes = isz * isz * (8 + 4 * A)
        b, by = bound_ms(nbytes(*args) + out_bytes, RASTER_OPS_PER_PAIR * pairs)
        log(f"{name} {what} F {args[0].shape[0]} at {isz}^2: {ms:.4f} ms "
            f"(the wrapper's pixel boxes and prefix sum {wrap:.4f} ms of it), "
            f"plain {pms:.3f} ms, bound {b:.5f} ms ({by}; {pairs} pixel-face "
            f"pairs in face boxes, {pairs / isz ** 2:.2f} a pixel), "
            f"library: none (no PyTorch call rasterizes)")
        table.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=TPU_KERNELS[name], launches=launches[name],
            max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b, bound_by=by,
            library_ms=None, shape=f"{what} F {args[0].shape[0]} at {isz}^2",
            box_pairs=pairs))

    check_lbam_and_small_fit(check_devices)
    return dict(table=table, launches=launches, times=times)


def small_texture_fit(device):
    """A cut-size texture fit: a 642-vertex sphere, its once-subdivided
    copy as the scan with a 128^2 colour atlas, 64^2 renders, a 64^2
    texture, 36 iterations."""
    from bodyfitting_torch.fitting import texture as tf
    from bodyfitting_torch.models.body_model import sphere_mesh
    from bodyfitting_torch.utils.uv_unwrap import per_face_atlas

    rng = np.random.default_rng(7)
    v, f = sphere_mesh(642, rng)
    sv, sf = subdivide(v, f.astype(np.int64))
    v, sv = v.astype(np.float32), sv.astype(np.float32)
    uvs, fu = per_face_atlas(len(sf))
    suv, sfu = per_face_atlas(len(f))
    tex, cov = tf.bake_displacement_map(uvs[fu], sf, colour_field(sv, 1),
                                        128, device=device)
    tex = tex + 0.5 * (1.0 - cov)[..., None]
    cfg = tf.TextureFitConfig(tex_img_size=64, render_img_size=64,
                              iter_num=36, round_views=6, round_view_iters=3,
                              lr=2e-2)
    out, losses = tf.fit_texture(v, f, suv[sfu], sv, sf, uvs[fu], tex, cfg,
                                 device=device)
    return out.cpu().numpy(), losses.cpu().numpy()


def check_lbam_and_small_fit(devices=("cuda", "cpu")):
    """LBAM on the card against the CPU at 256^2 (cuDNN without TF32), and
    a cut-size texture fit on the card (kernels) against the CPU (plain
    versions)."""
    import torch

    from bodyfitting_torch.models.inpaint import Inpainter

    rng = np.random.default_rng(3)
    img = rng.integers(0, 255, size=(256, 256, 3)).astype(np.uint8)
    mask = np.zeros((256, 256, 3), np.uint8)
    mask[60:140, 90:200] = 255
    outs = [Inpainter(seed=0, device=d)(img, mask) for d in devices]
    err = float(np.abs(outs[0] - outs[1]).max())
    log(f"check: LBAM at 256^2, card vs CPU (cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}): max abs err {err:.3e} (tol "
        f"2e-4: f32 convolutions summed in other orders over 13 levels)")
    assert err <= 2e-4
    fits = [small_texture_fit(d) for d in devices]
    (ta, la), (tb, lb) = fits
    rel = float(np.max(np.abs(la - lb) / np.abs(lb)))
    tmean = float(np.abs(ta - tb).mean())
    tmax = float(np.abs(ta - tb).max())
    log(f"check: 36-step small texture fit, card (kernels) vs CPU (plain): "
        f"loss trace max rel err {rel:.3e} (tol 1e-3), texture mean abs "
        f"diff {tmean:.3e} (tol 1e-4), max {tmax:.3e} (the projection's "
        f"matrix products and the scatter-add of the texture gradient sum "
        f"in other orders; Adam's normalised steps carry the last bits)")
    assert np.isfinite(la).all() and rel <= 1e-3 and tmean <= 1e-4


# ---------------------------------------------------------------------------
# The GeneBody app: python -m bodyfitting_torch.apps.genebody end to end
# ---------------------------------------------------------------------------

# The app's shape: the default keypoint-only SMPL-X run on 16 frames in two
# batches of 8 through the pipelined loop, with HMR on the keyframe; the
# --use_mask and --temporal runs on 8 frames; 48 views at the full capture
# resolution (2448 x 2048), crops at --load_size 512, 600 iterations, the
# synthetic SMPL-X (10,475 vertices) with FUSED_SKINNING = "on".
APP_PATH = dict(num_verts=10475, capture=(2448, 2048), focal=3600.0,
                dist=2.0, load_size=512, frames=16, batch=8, mask_frames=8,
                num_iters=600, temporal_iters=600, splat=4, hmr=True,
                bench_batch=128,
                # phase 13 (e): the keypoint run with and without
                # --data_parallel, cut in frames and depth
                dp_frames=2, dp_iters=120,
                # the largest mean reprojection error of a frame (px of the
                # 512^2 crops): twice the CPU rehearsal's worst frame
                # (9.9 / 27.9 / 10.2 px; the mask fit ends worse, as in
                # phase 3: Adam's transient at the gate)
                max_px=dict(keypoints=20.0, use_mask=56.0, temporal=20.0))
SUBJECT = "smoke"
SKIN_KERNELS = ("skin_forward", "skin_backward")
TPU_KERNELS.update(
    skin_forward="bodyfitting_tpu/ops/pallas_kernels.py:982",
    skin_backward="bodyfitting_tpu/ops/pallas_kernels.py:996")
SOURCES.update(skin_forward="bodyfitting_torch/ops/csrc/skinning.cu",
               skin_backward="bodyfitting_torch/ops/csrc/skinning.cu")


def _aa_to_rotmat_np(aa):
    import torch

    from bodyfitting_torch.ops.rotations import rodrigues

    return rodrigues(torch.tensor(np.asarray(aa, np.float64))).numpy()


def write_genebody_subject(root, model, size, seed=0, all_images=False):
    """A synthetic GeneBody subject under ``root/genebody/smoke``, written
    with the port's own writers: ``annots.npy`` with 48 ring cameras,
    ``mask/%02d/%04d.png`` at the capture resolution for every view and
    frame, ``image/00`` (the frame listing) and ``image/25`` (the HMR
    keyframe), and the OpenPose keypoints (body, hands, face) of seeded
    SMPL-X bodies projected into each view's 512^2 crop, plus 1 px of
    noise: these stand in for the openpose.bin run.  The bodies face the
    keyframe camera as HMR's mean pose does, turned by a seeded 0.15 rad.
    ``all_images`` writes an RGB image for every view instead: the body's
    splat shaded by height and a smooth pattern, on a plain background.
    Returns the keypoints and what the checks need."""
    import torch

    from bodyfitting_torch.io.cameras import save_annots
    from bodyfitting_torch.io.images import adjust_K_for_crop, mask_square_bbox
    from bodyfitting_torch.io.png import write_png
    from bodyfitting_torch.models import body_model as bm
    from bodyfitting_torch.ops.rotations import rotmat_to_aa_np
    from concurrent.futures import ThreadPoolExecutor

    W, H = size["capture"]
    F, n_views, key = size["frames"], 48, 25
    sub = os.path.join(root, "genebody", SUBJECT)
    c2ws, Ks = ring_cameras(n_views, W, size["focal"], size["dist"], height=H)
    os.makedirs(sub)
    save_annots(os.path.join(sub, "annots.npy"), np.stack(Ks), np.stack(c2ws))
    rng = np.random.default_rng(seed)
    orient = np.stack([rotmat_to_aa_np(
        c2ws[key][:3, :3] @ _aa_to_rotmat_np(rng.normal(scale=0.15, size=3)))
        for _ in range(F)])

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=model.device)

    gt = dataclasses.replace(
        bm.BodyParams.zeros(model, F),
        body_pose=t(rng.normal(scale=0.15, size=(F, 3 * model.num_body_joints))),
        betas=t(rng.normal(scale=0.5, size=(F, model.num_betas))),
        global_orient=t(orient))
    with torch.no_grad():
        out = bm.forward(model, gt)
    transl = rng.normal(scale=0.03, size=(F, 1, 3))
    scale = 0.3 * 1.15
    joints = (out.joints.cpu().numpy() + transl) * scale
    verts = (out.vertices.cpu().numpy()[:, ::4] + transl) * scale
    s = size["splat"]

    def mask_of(f, v):
        """The view's silhouette, splatted at 1/s of the capture size and
        blown up, so 768 full-resolution masks take seconds."""
        m = splat_mask(project(verts[f], c2ws[v], Ks[v]) / s, W // s,
                       size.get("mask_dilate", 2), height=H // s)
        return np.repeat(np.repeat((m > 0).astype(np.uint8) * 255, s, 0), s, 1)

    def shaded(m, v):
        """The view's RGB image: the silhouette shaded by height and a
        smooth pattern on a plain grey background."""
        h, w = m.shape
        y = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
        x = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
        lum = 0.55 + 0.25 * np.cos(9.0 * y + 0.3 * v) * np.cos(7.0 * x)
        skin = np.array([205.0, 150.0, 120.0], np.float32)
        img = np.where((m > 0)[..., None], skin * lum[..., None], 96.0)
        return img.astype(np.uint8)

    image_views = range(n_views) if all_images else (0, key)
    for v in range(n_views):
        os.makedirs(os.path.join(sub, "mask", "%02d" % v))
    for v in image_views:
        os.makedirs(os.path.join(sub, "image", "%02d" % v))

    def write_view(job):
        f, v = job
        m = mask_of(f, v)
        t0 = time.perf_counter()
        write_png(os.path.join(sub, "mask", "%02d" % v, "%04d.png" % f), m,
                  level=1)
        dt = time.perf_counter() - t0
        if v in image_views:
            img = (shaded(m, v) if all_images
                   else np.repeat(m[..., None] // 2, 3, 2))   # grey person
            write_png(os.path.join(sub, "image", "%02d" % v, "%04d.png" % f),
                      img, level=1)
        bbox = mask_square_bbox(m)
        Kc = adjust_K_for_crop(Ks[v], bbox, size["load_size"])
        return (f, v), Kc, dt

    t0 = time.perf_counter()
    jobs = [(f, v) for f in range(F) for v in range(n_views)]
    with ThreadPoolExecutor(8) as ex:
        done = list(ex.map(write_view, jobs))
    write_s = time.perf_counter() - t0
    crop_K = {fv: Kc for fv, Kc, _ in done}
    png_ms = 1e3 * float(np.mean([dt for _, _, dt in done]))
    clean, kps = {}, {}
    for (f, v), Kc in crop_K.items():
        uv = project(joints[f], c2ws[v], Kc)
        clean[f, v] = uv
        kp = np.concatenate([uv + rng.normal(scale=1.0, size=uv.shape),
                             np.ones((len(uv), 1))], 1)
        # OpenPose face order: 17 contour points, then 51 inner ones
        face = np.concatenate([kp[67 + 51:], kp[67:67 + 51]])
        kps[f, v] = {"pose_keypoints_2d": kp[:25],
                     "hand_left_keypoints_2d": kp[25:46],
                     "hand_right_keypoints_2d": kp[46:67],
                     "face_keypoints_2d": face}
    t0 = time.perf_counter()
    from bodyfitting_torch.io.png import read_png

    probe = [os.path.join(sub, "mask", "%02d" % v, "%04d.png" % 0)
             for v in range(0, n_views, 6)]
    for p in probe:
        read_png(p)
    decode_ms = (time.perf_counter() - t0) / len(probe) * 1e3
    log(f"app subject: {F} frames x {n_views} views, masks {W}x{H} written "
        f"in {write_s:.2f} s ({png_ms:.2f} ms per mask encode, 8 threads), "
        f"PNG decode {decode_ms:.2f} ms per mask (read_png, one thread)")
    return dict(sub=sub, c2ws=c2ws, Ks=Ks, crop_K=crop_K, clean=clean,
                kps=kps, write_s=write_s, encode_ms=png_ms,
                decode_ms=decode_ms)


def write_keypoint_jsons(out_dir, kps, frames):
    for (f, v), person in kps.items():
        if f not in frames:
            continue
        d = os.path.join(out_dir, SUBJECT, "%06d" % f, "openpose")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "%02d_keypoints.json" % v), "w") as fh:
            json.dump({"people": [{k: np.asarray(b).reshape(-1).tolist()
                                   for k, b in person.items()}]}, fh)


def subject_of_first_frames(root, subject_dir, n, name="genebody8"):
    """A second subject (under ``root/name``) whose frame listing holds the
    first ``n`` frames; masks, keyframe images and cameras are the first
    subject's (links)."""
    dst = os.path.join(root, name, SUBJECT)
    os.makedirs(os.path.join(dst, "image", "00"))
    os.symlink(os.path.join(subject_dir, "annots.npy"),
               os.path.join(dst, "annots.npy"))
    os.symlink(os.path.join(subject_dir, "mask"), os.path.join(dst, "mask"))
    os.symlink(os.path.join(subject_dir, "image", "25"),
               os.path.join(dst, "image", "25"))
    for f in range(n):
        name = "%04d.png" % f
        os.symlink(os.path.join(subject_dir, "image", "00", name),
                   os.path.join(dst, "image", "00", name))
    return os.path.dirname(dst)


class SkinRecorder:
    """Keeps, at each vertex count, the first inputs that the fused
    skinning gets and the inputs and output cotangent of its last
    differentiated call (a fit's last, masked step), without touching the
    counted wrappers: it wraps ``skinning.fused_skinning``, which ``lbs``
    looks up at each call, and hooks the output's gradient."""

    def __init__(self):
        self.fwd, self.bwd = {}, {}

    @contextlib.contextmanager
    def active(self):
        from bodyfitting_torch.ops.kernels import skinning as S

        orig = S.fused_skinning

        def wrapped(W, A, vp):
            V = W.shape[0]
            out = orig(W, A, vp)
            args = tuple(x.detach() for x in (W, A, vp))
            self.fwd.setdefault(V, tuple(x.clone() for x in args))
            if out.requires_grad:
                def hook(g, V=V, args=args):
                    self.bwd[V] = args + (g.detach(),)
                out.register_hook(hook)
            return out

        S.fused_skinning = wrapped
        try:
            yield self
        finally:
            S.fused_skinning = orig


@contextlib.contextmanager
def fit_recorder(store):
    """Keeps the arguments and result of each ``fit_frames_batched`` call
    of the app."""
    from bodyfitting_torch.fitting import body_fitting as bf

    orig = bf.fit_frames_batched

    def wrapped(model, config, obs_list, init_list, prior):
        out = orig(model, config, obs_list, init_list, prior)
        store.append(dict(model=model, config=config, obs_list=obs_list,
                          init_list=init_list, prior=prior, params=out[0]))
        return out
    bf.fit_frames_batched = wrapped
    try:
        yield store
    finally:
        bf.fit_frames_batched = orig


def run_app(argv, device, app=None):
    """``app.main(argv)`` (default ``bodyfitting_torch.apps.genebody``) with
    the launch counts zeroed just before and read just after; returns
    (wall s, counts, what ``main`` returned)."""
    from bodyfitting_torch.ops import kernels as K

    if app is None:
        from bodyfitting_torch.apps import genebody as app
    sync(device)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = app.main(argv, device=device)
    sync(device)
    return time.perf_counter() - t0, K.launch_counts(), out


def read_app_outputs(out_dir, frames):
    """Every frame's saved parameters, OBJ, loss trace and the timing."""
    from bodyfitting_torch.io.params import PARAM_KEYS

    sub = os.path.join(out_dir, SUBJECT)
    params = {}
    for f in frames:
        obj = os.path.join(sub, "smpl", "%04d.obj" % f)
        assert os.path.getsize(obj) > 0, obj
        d = np.load(os.path.join(sub, "param", "%04d.npy" % f),
                    allow_pickle=True).item()
        assert set(PARAM_KEYS) <= set(d), sorted(d)
        for k in PARAM_KEYS:
            assert np.isfinite(d[k]).all(), (f, k)
        params[f] = d
    trace = {}
    for line in open(os.path.join(sub, "loss_trace.jsonl")):
        rec = json.loads(line)
        trace[rec["frame"]] = np.asarray(rec["losses"])
    assert sorted(trace) == sorted(frames), sorted(trace)
    timing = None
    tpath = os.path.join(sub, "timing.json")
    if os.path.exists(tpath):
        timing = json.load(open(tpath))
    return params, trace, timing


def reprojection_px(subject, params, frames):
    """Mean and max over frames of the mean distance (pixels of the 512^2
    crops) between the fitted joints' projections and the noiseless
    projections of the ground truth's, over the 135 keypoints and 48
    views."""
    per = []
    for f in frames:
        j = params[f]["joints"][:135]
        d = [np.linalg.norm(project(j, subject["c2ws"][v],
                                    subject["crop_K"][f, v])
                            - subject["clean"][f, v], axis=1).mean()
             for v in range(48)]
        per.append(float(np.mean(d)))
    return float(np.mean(per)), float(np.max(per))


# Instruction issue of one H100 SXM for float32 work built with
# -fmad=false (each multiply and add its own instruction): 132 SMs x 128
# lanes x 1.98 GHz.  The skinning's operation count over this rate is the
# floor its kernels can reach; skin_bound divides by the published peak,
# which counts a fused multiply-add as two.
F32_ISSUE_PER_S = 132 * 128 * 1.98e9

# Device microseconds (forward, backward) of the skinning kernels' previous
# design (a block a 128-vertex tile and frame; the backward's tile sum a
# second launch), measured by this script's phase 9 on an NVIDIA H100 80GB
# HBM3 at 700 W, at the shapes the app gives them and the bench batch.
SKIN_BEFORE_US = {(8, 564): (15.1, 22.6), (8, 3035): (15.9, 25.1),
                  (8, 10475): (18.5, 38.3), (128, 10475): (213.6, 427.0)}


def tensor_sha1(t):
    """sha1 of a tensor's bytes (on the host)."""
    return hashlib.sha1(np.ascontiguousarray(
        t.detach().cpu().numpy()).tobytes()).hexdigest()


def params_sha1(params):
    """sha1 of an app run's fitted parameters: every frame's arrays, in
    frame and key order."""
    h = hashlib.sha1()
    for f in sorted(params):
        for k in sorted(params[f]):
            h.update(k.encode())
            h.update(np.ascontiguousarray(params[f][k]).tobytes())
    return h.hexdigest()


def skin_bound(B, V, J, backward):
    """Bytes and operations of the function itself: W, A and vp (and g)
    read once, the outputs written once. The forward needs 2 J 12
    operations a vertex for T and 18 for the 3x4 apply. The backward
    needs T's 3x3 rotation part (2 J 9) and 15 for dvp, 9 for the
    products g[r] vp[k], and 2 J 12 for dA; its tile partials are the
    kernel's own and are not counted."""
    if not backward:
        return bound_ms(4 * (V * J + B * J * 12 + 2 * B * V * 3),
                        B * V * (24 * J + 18))
    return bound_ms(4 * (V * J + 2 * B * J * 12 + 3 * B * V * 3),
                    B * V * (42 * J + 24))


def time_skinning(W, A, vp, g):
    """Device ms of the kernels, their plain versions and the "auto" path
    (``torch.matmul`` + ``einsum``, two calls; its backward through
    autograd), on the same inputs."""
    import torch

    from bodyfitting_torch.ops import kernels as K

    B, V, _ = vp.shape
    reps = 20 if B * V < 2e5 else 10
    ms_f = cuda_ms(lambda: K.skin_forward(W, A, vp), reps=reps)
    ms_b = cuda_ms(lambda: K.skin_backward(W, A, vp, g), reps=reps)
    plain_f = cuda_ms(lambda: K.skin_forward_plain(W, A, vp), reps=2,
                      warmup=1)
    plain_b = cuda_ms(lambda: K.skin_backward_plain(W, A, vp, g), reps=2,
                      warmup=1)

    def auto(a, v):
        T = torch.matmul(W, a).reshape(B, V, 3, 4)
        return torch.einsum("bvij,bvj->bvi", T[..., :3], v) + T[..., 3]

    auto_f = cuda_ms(lambda: auto(A, vp), reps=reps)
    a_, v_ = A.clone().requires_grad_(True), vp.clone().requires_grad_(True)
    out = auto(a_, v_)
    auto_b = cuda_ms(lambda: torch.autograd.grad(out, [a_, v_], g,
                                                 retain_graph=True),
                     reps=reps)
    return dict(fwd=(ms_f, plain_f, auto_f), bwd=(ms_b, plain_b, auto_b))


def skin_forward_row(W, A, vp, launches, phase, on_card, timed=True):
    """The kernel table's ``skin_forward`` row at ``(W, A, vp)``: the
    kernel held bitwise against its plain version (tol: exact), and, on
    the card with ``timed``, timed beside its plain version, the "auto"
    path (``matmul`` + ``einsum``) and its bound.  ``launches`` is the
    count of the path's run, read before this call."""
    import torch

    from bodyfitting_torch.ops import kernels as K

    out = K.skin_forward(W, A, vp)
    ref = K.skin_forward_plain(W, A, vp)
    same = torch.equal(out, ref)
    err = float((out - ref).abs().max())
    B, V, J = vp.shape[0], vp.shape[1], W.shape[1]
    log(f"skin_forward at {phase} (B {B}, V {V}, J {J}): bitwise equal to "
        f"the plain version: {same} (tol: exact); max abs err {err:.3e}")
    assert same, f"skin_forward differs from its plain version ({phase})"
    row = dict(name="skin_forward", route="cuda",
               source=SOURCES["skin_forward"],
               replaces=TPU_KERNELS["skin_forward"], launches=launches,
               max_abs_err=err, ms=None, plain_ms=None, bound_ms=None,
               bound_by=None, library_ms=None, phase=phase,
               shape=f"B {B} V {V}")
    if on_card and timed:
        ms = cuda_ms(lambda: K.skin_forward(W, A, vp), reps=20)
        plain = cuda_ms(lambda: K.skin_forward_plain(W, A, vp), reps=2,
                        warmup=1)

        def auto():
            T = torch.matmul(W, A).reshape(B, V, 3, 4)
            return torch.einsum("bvij,bvj->bvi", T[..., :3], vp) + T[..., 3]

        lib = cuda_ms(auto, reps=20)
        b, by = skin_bound(B, V, J, False)
        log(f"skin_forward ({phase}) B {B} V {V}: {ms:.4f} ms, plain "
            f"{plain:.3f} ms, \"auto\" (matmul + einsum) {lib:.4f} ms, "
            f"bound {b:.5f} ms ({by})")
        row.update(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                   library_ms=lib)
    return row


def check_skin_kernels(rec, device, bench_batch, seed=0):
    """The kernels against their plain versions at every shape the app gave
    them (the backward at full width on a seeded cotangent), then timed
    there and at ``bench_batch`` frames of the full width."""
    import torch

    from bodyfitting_torch.ops import kernels as K
    from bodyfitting_torch.ops.kernels import skinning

    gen = np.random.default_rng(seed)
    cases = {}
    for V, (W, A, vp) in sorted(rec.fwd.items()):
        g = rec.bwd[V][3] if V in rec.bwd else torch.as_tensor(
            gen.normal(size=vp.shape).astype(np.float32), device=vp.device)
        cases[V] = rec.bwd[V] if V in rec.bwd else (W, A, vp, g)
    full = max(cases)
    W, A, vp, _ = cases[full]
    Bb = bench_batch
    Ab = torch.as_tensor(gen.normal(size=(Bb,) + A.shape[1:]).astype(
        np.float32), device=A.device) * 0.1 + A[:1]
    vpb = vp[:1].expand(Bb, -1, -1).contiguous() + torch.as_tensor(
        gen.normal(scale=0.01, size=(Bb,) + vp.shape[1:]).astype(np.float32),
        device=vp.device)
    gb = torch.as_tensor(gen.normal(size=vpb.shape).astype(np.float32),
                         device=vp.device)
    rows, err = [], 0.0
    for what, (W, A, vp, g) in [(f"V {V}", c) for V, c in cases.items()] + [
            (f"B {Bb} full width", (W, Ab, vpb, gb))]:
        out = K.skin_forward(W, A, vp)
        dA, dvp = K.skin_backward(W, A, vp, g)
        ref = K.skin_forward_plain(W, A, vp)
        rdA, rdvp = K.skin_backward_plain(W, A, vp, g)
        sync(device)
        same = (torch.equal(out, ref) and torch.equal(dA, rdA)
                and torch.equal(dvp, rdvp))
        e = max(float((a - b).abs().max()) for a, b in
                ((out, ref), (dA, rdA), (dvp, rdvp)))
        err = max(err, e)
        B, V, _ = vp.shape
        J = W.shape[1]
        log(f"skinning {what} (B {B}, V {V}, J {J}): out, dA and dvp "
            f"bitwise equal to the plain versions: {same} (tol: exact); max "
            f"abs err {e:.3e}")
        assert same, f"the skinning kernels differ from plain ({what})"
        if torch.device(device).type != "cuda":
            continue
        tm = time_skinning(W, A, vp, g)
        for kind in ("fwd", "bwd"):
            ms, plain, auto = tm[kind]
            b, by = skin_bound(B, V, J, kind == "bwd")
            geo = skinning.kernel_geometry(B, V, J, kind == "bwd")
            assert geo == skinning.launch_geometry(B, V, J, kind == "bwd"), \
                f"skinning {kind} geometry {geo} is not launch_geometry's"
            ops = B * V * (42 * J + 24 if kind == "bwd" else 24 * J + 18)
            before = SKIN_BEFORE_US.get((B, V))
            log(f"skinning {kind} {what}: {ms:.4f} ms, plain {plain:.3f} ms, "
                f"\"auto\" (matmul + einsum{'' if kind == 'fwd' else ', autograd backward'}) "
                f"{auto:.4f} ms, bound {b:.5f} ms ({by}), -fmad=false issue "
                f"floor {ops / F32_ISSUE_PER_S * 1e3:.5f} ms ({ops / 1e9:.3f} "
                f"G instructions); previous design "
                + (f"{before[kind == 'bwd'] / 1e3:.4f} ms" if before else "not "
                   "measured at this shape")
                + f"; launch {geo}")
            rows.append(dict(what=what, kind=kind, B=B, V=V, ms=ms,
                             plain_ms=plain, library_ms=auto, bound_ms=b,
                             bound_by=by))
    return rows, err


def phase_app(size=APP_PATH, device="cuda", smi=""):
    """The GeneBody app end to end on a synthetic subject: (a) the default
    keypoint-only SMPL-X run with HMR, 16 frames in two batches through the
    pipelined loop, with --timing; (b) --use_mask on 8 frames; (c)
    --temporal on 8 frames; every run with FUSED_SKINNING = "on"."""
    import tempfile

    import torch

    from bodyfitting_torch.apps import genebody as app
    from bodyfitting_torch.models import body_model as bm
    from bodyfitting_torch.models.hmr import seeded_state_dict

    on_card = torch.device(device).type == "cuda"
    tmp = tempfile.TemporaryDirectory(prefix="bodyfit_app_")
    root = tmp.name
    bm.FUSED_SKINNING = "on"
    try:
        argv0 = ["--smpl_type", "smplx", "--subject", SUBJECT,
                 "--load_size", str(size["load_size"]),
                 "--synthetic_num_verts", str(size["num_verts"]),
                 "--batch_frames", str(size["batch"])]
        model = app.load_body_model(app.config_parser().parse_args(argv0),
                                    device=device)
        subject = write_genebody_subject(root, model, size)
        ckpt = os.path.join(root, "hmr.pth")
        t0 = time.perf_counter()
        torch.save(seeded_state_dict(0), ckpt)
        log(f"app: seeded HMR checkpoint written in "
            f"{time.perf_counter() - t0:.2f} s")
        F, n8, iters = size["frames"], size["mask_frames"], size["num_iters"]
        root8 = subject_of_first_frames(root, subject["sub"], n8)
        runs, rec, fits = {}, SkinRecorder(), []
        plan = (
            ("keypoints", os.path.join(root, "genebody"), range(F),
             ["--tasks", "openpose", "smplify", "output", "--timing",
              "--num_iters", str(iters)]
             + (["--hmr_checkpoint", ckpt] if size["hmr"] else [])),
            ("use_mask", root8, range(n8),
             ["--use_mask", "--timing", "--num_iters", str(iters)]),
            ("temporal", root8, range(n8),
             ["--temporal", "--timing", "--num_iters",
              str(size["temporal_iters"])]),
        )
        for name, target, frames, extra in plan:
            out = os.path.join(root, "out_" + name)
            write_keypoint_jsons(out, subject["kps"], set(frames))
            argv = argv0 + ["--target_dir", target, "--output_dir", out] + extra
            with rec.active(), fit_recorder(fits):
                wall, counts, _ = run_app(argv, device)
            n_iter = int(extra[extra.index("--num_iters") + 1])
            batches = -(-len(frames) // size["batch"])
            expect = dict(skin_forward=batches * (n_iter + 1),
                          skin_backward=batches * n_iter)
            params, trace, timing = read_app_outputs(out, list(frames))
            px = reprojection_px(subject, params, list(frames))
            digest = params_sha1(params)
            log(f"app run {name}: fitted parameters sha1 {digest} "
                f"(FUSED_SKINNING \"on\")")
            runs[name] = dict(wall=wall, counts=counts, expect=expect,
                              trace=trace, timing=timing, px=px,
                              params_sha1=digest, params=params,
                              fit=fits[-1] if name == "use_mask" else None,
                              frames=len(frames), iters=n_iter)
            log(f"app run {name}: {len(frames)} frames, {n_iter} iterations, "
                f"{wall:.3f} s wall ({len(frames) / wall:.3f} frames/s); "
                f"launches {counts} (skinning expected {expect}); fitted "
                f"joints reproject {px[0]:.3f} px from the ground truth's "
                f"keypoints on average (worst frame {px[1]:.3f} px)")
            log(f"app run {name} timing.json: " + json.dumps(timing))
            if on_card:
                for k in SKIN_KERNELS:
                    assert counts[k] == expect[k], (name, counts, expect)
        # the masked stage descends from its post-gate peak (phase 3's rule)
        gate = iters // 3
        for f, tr in runs["use_mask"]["trace"].items():
            post = tr[gate + 1:]
            assert tr[gate + 1] > tr[gate], f"mask term not live (frame {f})"
            assert post[-50:].mean() < 0.9 * post.max(), \
                f"the masked stage did not descend (frame {f})"
        for name, r in runs.items():
            assert r["px"][1] <= size["max_px"][name], (name, r["px"])

        rows, err = check_skin_kernels(rec, device, size["bench_batch"])
        onoff = check_on_off(runs["use_mask"]["fit"], device)
        # phase 13 (e): the keypoint run on the first frames with
        # --data_parallel (a world of one) against the same run without
        n_dp = size["dp_frames"]
        root_dp = subject_of_first_frames(root, subject["sub"], n_dp,
                                          "genebody_dp")
        dp = dict(frames=n_dp)
        for name, extra in (("single", []), ("dp", ["--data_parallel"])):
            out = os.path.join(root, "out_dp_" + name)
            write_keypoint_jsons(out, subject["kps"], set(range(n_dp)))
            wall, _, _ = run_app(argv0 + [
                "--target_dir", root_dp, "--output_dir", out, "--tasks",
                "smplify", "output", "--num_iters", str(size["dp_iters"])]
                + extra, device)
            params, _, _ = read_app_outputs(out, list(range(n_dp)))
            dp[name], dp[name + "_s"] = params_sha1(params), wall
        # what phase 12 (c) overlays: frame 0 of the keypoint run, at the
        # JAX cadence (every 12th view), over grey-person images
        from bodyfitting_torch.io.png import read_png

        views = range(0, 48, 12)
        masks = {v: read_png(os.path.join(subject["sub"], "mask",
                                           "%02d" % v, "%04d.png" % 0))
                 for v in views}
        overlay = dict(
            vertices=runs["keypoints"]["params"][0]["vertices"],
            faces=model.faces.cpu().numpy(),
            c2ws=subject["c2ws"], Ks=subject["Ks"],
            images=[np.repeat((masks[v] // 2)[..., None], 3, 2)
                    if v in masks else None for v in range(48)])
        return dict(runs=runs, rows=rows, err=err, onoff=onoff,
                    overlay=overlay, data_parallel=dp,
                    subject=dict(write_s=subject["write_s"],
                                 encode_ms=subject["encode_ms"],
                                 decode_ms=subject["decode_ms"]))
    finally:
        bm.FUSED_SKINNING = "auto"
        tmp.cleanup()


def check_on_off(fit, device):
    """At the mask run's final state: the loss and gradient with the
    fused kernels ("on") against the matmul path ("auto"), and the
    post-gate step time of each from that state."""
    import torch

    from bodyfitting_torch.fitting import smplify
    from bodyfitting_torch.models import body_model as bm

    model, config, prior = fit["model"], fit["config"], fit["prior"]
    obs = smplify.concat_frames(fit["obs_list"])
    params = fit["params"]
    models = smplify.loss_models(model, config)
    gate = config.num_iters // config.stage_gate_den
    errs = {}
    for what, step in (("keypoint stage", gate),
                       ("masked stage", config.num_iters - 1)):
        got = {}
        for mode in ("on", "auto"):
            bm.FUSED_SKINNING = mode
            got[mode] = loss_and_grads(models, config, params, obs, prior,
                                       step)
        (lk, gk), (lp, gp) = got["on"], got["auto"]
        top = max(float(g.abs().max()) for g in gp)
        errs[what] = (float(((lk - lp).abs() / lp.abs()).max()),
                      max(float((a - b).abs().max())
                          for a, b in zip(gk, gp)) / top)
    with torch.no_grad():
        verts = {}
        for mode in ("on", "auto"):
            bm.FUSED_SKINNING = mode
            verts[mode] = bm.forward(models[0], params.body).vertices
        vert_err = float((verts["on"] - verts["auto"]).abs().max()
                         / verts["auto"].abs().max())
    (kl, kg), (ml, mg) = errs["keypoint stage"], errs["masked stage"]
    log(f"check: at the mask run's final state, \"on\" vs \"auto\": the "
        f"reduced model's vertices max err {vert_err:.3e} of their extent "
        f"(tol 1e-5); keypoint-stage loss (step {gate}) max rel err "
        f"{kl:.3e} (tol 1e-5), gradient {kg:.3e} of the largest entry (tol "
        f"1e-4); masked-stage loss (step {config.num_iters - 1}) max rel "
        f"err {ml:.3e} (tol 1e-5), gradient {mg:.3e} of the largest entry "
        f"(tol 1e-4)")
    assert vert_err <= 1e-5, vert_err
    assert kl <= 1e-5 and kg <= 1e-4, errs["keypoint stage"]
    assert ml <= 1e-5 and mg <= 1e-4, errs["masked stage"]
    times = {}
    for mode in ("auto", "on", "on", "auto"):
        bm.FUSED_SKINNING = mode
        fresh = smplify.FitParams.from_tensors(
            [p.clone() for p in params.tensors()])
        opt = smplify.make_optimizer(config, fresh)
        step_fn = smplify.make_step_fn(model, config, obs, prior, opt)
        steps_ms(step_fn, range(gate + 1, gate + 4), device)
        times.setdefault(mode, []).append(
            steps_ms(step_fn, range(gate + 4, gate + 34), device))
    bm.FUSED_SKINNING = "on"
    log("post-gate mask step at the same state, ms (host clock, 30 steps, "
        "in the order auto, on, on, auto): "
        + ", ".join(f"{m} {' / '.join(f'{t:.3f}' for t in v)}"
                    for m, v in times.items()))
    return dict(vert_err=vert_err, errs=errs, step_ms=times)


def skin_rows(app):
    """The two skinning rows of the kernel table: timed at the keypoint
    run's joints-reduced shape (1,200 of its 1,202 forward launches),
    every other captured shape and the bench batch under ``shapes``."""
    keyp = app["runs"]["keypoints"]
    table = []
    for name, kind in (("skin_forward", "fwd"), ("skin_backward", "bwd")):
        mine = [r for r in app["rows"] if r["kind"] == kind]
        head = min(mine, key=lambda r: (r["B"] != 8, r["V"]))
        table.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=TPU_KERNELS[name], launches=keyp["counts"][name],
            max_abs_err=app["err"], ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"],
            shape=f"B {head['B']} V {head['V']}",
            launches_by_run={k: r["counts"][name]
                             for k, r in app["runs"].items()},
            shapes=[{k: r[k] for k in ("what", "B", "V", "ms", "plain_ms",
                                       "library_ms", "bound_ms", "bound_by")}
                    for r in mine]))
    return table


# ---------------------------------------------------------------------------
# The RenderPeople app: python -m bodyfitting_torch.apps.renderpeople
# ---------------------------------------------------------------------------

# The app's shape: --smpl_type smpl --viewnum 8 --load_size 512 on the scan
# phase's scan (the synthetic SMPL of 6,846 vertices, its posed surface
# subdivided twice: 219,008 faces), textured with the committed 2048^2 JPEG;
# (a) every task but openpose with --auto_uv --inpaint --disp_map --debug
# and the seeded HMR checkpoint, 600 + 600 iterations and 200 texture
# iterations; (b) texfit and output again on (a)'s caches; (c) --use_mask
# smplify, 120 iterations.
RP_APP_PATH = dict(num_verts=6890, viewnum=8, load_size=512, subdivisions=2,
                   num_iters=600, tex_iters=200, mask_iters=120,
                   # SMPL+D's mean distance to the scan (mm; phase 6: 2.8-3.9)
                   # and the fitted joints' mean reprojection error (px of
                   # the 512^2 views; phase 9's keypoint bound)
                   max_mm=10.0, max_px=20.0)
RP_SUBJECT = "rp_smoke"
JPEG_FIXTURES = os.path.join(REPO, "tests", "data", "jpeg")


def write_smpl_asset(path, model):
    """``model`` as a SMPL asset that ``load_model`` reads back exactly
    (an ``.npz`` of the ``.pkl``'s arrays, float32)."""
    V, J = model.num_verts, len(model.parents)

    def a(t):
        return t.detach().cpu().numpy()

    parents = np.asarray(model.parents, np.int64)
    np.savez(path, v_template=a(model.v_template),
             shapedirs=a(model.shapedirs).T.reshape(V, 3, -1),
             posedirs=a(model.posedirs).T.reshape(V, 3, -1),
             J_regressor=a(model.J_regressor), weights=a(model.lbs_weights),
             f=a(model.faces).astype(np.int64),
             kintree_table=np.stack([parents, np.arange(J)]))


def cylinder_uvs(verts):
    """Per-vertex UVs of a cylindrical projection about the vertical axis
    through the centre: u the angle, v the height."""
    c = 0.5 * (verts.min(0) + verts.max(0))
    u = 0.5 + np.arctan2(verts[:, 0] - c[0], verts[:, 2] - c[2]) / (2 * np.pi)
    v = (verts[:, 1] - verts[:, 1].min()) / np.ptp(verts[:, 1])
    return np.stack([u, v], 1).astype(np.float32)


def write_rp_scans(root, model, size, seed=0, scan=None):
    """A RenderPeople directory with one scan: the scan phase's problem for
    ``model`` (or ``scan``, its ``(verts, faces, joints)`` as a card made
    them) written as ``scans/<subject>/<subject>.obj`` (``v``, ``vt``,
    ``f v/vt``) with an MTL whose ``map_Kd`` names the committed 2048^2
    JPEG, copied to ``tex/``.  Returns the scan as the app loads it, the
    ground truth's joints, the scan's arrays, and the OBJ parse and JPEG
    decode times."""
    import shutil

    from bodyfitting_torch.io.images import imread_checked
    from bodyfitting_torch.io.obj import load_obj, save_obj_uv

    if scan is None:
        *_, sv, sf, joints = make_scan_problem(
            model, size["viewnum"], size["load_size"], size["subdivisions"],
            seed=seed, with_joints=True)
    else:
        sv, sf, joints = scan
    d = os.path.join(root, "scans", RP_SUBJECT)
    os.makedirs(os.path.join(d, "tex"))
    obj = os.path.join(d, RP_SUBJECT + ".obj")
    t0 = time.perf_counter()
    save_obj_uv(obj, sv, sf, cylinder_uvs(sv), sf)
    with open(os.path.join(d, RP_SUBJECT + ".mtl"), "a") as f:
        f.write(f"map_Kd tex/{RP_SUBJECT}_dif_2k.jpg\n")
    jpg = os.path.join(d, "tex", f"{RP_SUBJECT}_dif_2k.jpg")
    shutil.copy(os.path.join(JPEG_FIXTURES, "texture_2048.jpg"), jpg)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    load_obj(obj)
    parse_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    imread_checked(jpg)
    decode_s = time.perf_counter() - t0
    scan = load_obj(obj, load_texture=True)
    assert scan.texture.shape == (2048, 2048, 3)
    return dict(scan=scan, joints=joints, obj=obj, write_s=write_s,
                arrays=(sv, sf, joints), parse_s=parse_s, decode_s=decode_s,
                obj_mib=os.path.getsize(obj) / 2 ** 20)


def normals_ms(verts, faces, ordered):
    """Host-clock ms of the vertex normals and the smoothness term,
    forward and backward: the port's fixed-order sums, or the same
    function through ``index_add`` and autograd's gathers (atomic on
    the card)."""
    import torch

    from bodyfitting_torch.losses import mesh

    def atomic(v):
        f = faces.long()
        tris = v[f]
        fn = mesh._unit(torch.linalg.cross(tris[:, 1] - tris[:, 0],
                                           tris[:, 2] - tris[:, 0], dim=-1))
        vn = torch.zeros_like(v)
        for k in range(3):
            vn = vn.index_add(0, f[:, k], fn)
        vn = mesh._unit(vn)
        na, nb, nc = (vn[f[:, k]] for k in range(3))
        return vn.sum() + (((na - nb) ** 2).sum(-1) + ((nc - na) ** 2).sum(-1)
                           + ((nb - nc) ** 2).sum(-1)).mean()

    def port(v):
        vn = mesh.compute_vertex_normals(v, faces)
        return vn.sum() + mesh.normal_laplacian_smoothness(vn, faces)

    fn = port if ordered else atomic

    def once():
        v = verts.clone().requires_grad_(True)
        torch.autograd.grad(fn(v), [v])

    return host_ms(once, reps=20)


@contextlib.contextmanager
def keep_volume(store):
    """Keeps each distance volume the app builds."""
    from bodyfitting_torch.ops import sdf

    orig = sdf.build_distance_volume

    def wrapped(*a, **kw):
        store.append(orig(*a, **kw))
        return store[-1]

    sdf.build_distance_volume = wrapped
    try:
        yield store
    finally:
        sdf.build_distance_volume = orig


def save_rp_inputs(path, arrays, out_dir, size, volume):
    """Phase 10 (c)'s inputs that the card made: the scan and its joints,
    the rendered views the app cached, and its distance volume."""
    from bodyfitting_torch.io.png import read_png

    sv, sf, joints = arrays
    sub = os.path.join(out_dir, RP_SUBJECT)
    views = {d: np.stack([read_png(os.path.join(sub, d, "%02d.png" % i))
                          for i in range(size["viewnum"])])
             for d in ("images", "masks")}
    np.savez_compressed(path, scan_verts=sv, scan_faces=sf, joints=joints,
                        **views, **{f"vol_{k}": getattr(volume, k).cpu()
                                    .numpy() for k in ("dist", "face_idx",
                                                       "origin", "spacing")})
    log(f"rp app: run (c)'s scan, joints, views and volume saved to {path} "
        f"(for tests/rp_mask_fit_vs_jax.py)")


def check_jpeg_fixtures():
    """Each committed fixture decodes to the sha1 of OpenCV's decode,
    recorded beside it; returns the decode times (s)."""
    from bodyfitting_torch.io.images import imread_checked

    record = json.load(open(os.path.join(JPEG_FIXTURES, "fixtures.json")))
    times = {}
    for name, rec in sorted(record.items()):
        t0 = time.perf_counter()
        img = imread_checked(os.path.join(JPEG_FIXTURES, name))
        times[name] = time.perf_counter() - t0
        digest = hashlib.sha1(img.tobytes()).hexdigest()
        log(f"jpeg fixture {name}: {img.shape}, decode sha1 {digest} "
            f"(OpenCV's {rec['sha1']}) in {times[name] * 1e3:.1f} ms")
        assert list(img.shape) == rec["shape"] and digest == rec["sha1"], \
            (name, digest, rec)
    return times


def write_rp_keypoints(out_dir, joints, w2cs, K, seed=0):
    """OpenPose BODY_25 JSONs of the ground truth's joints in each of the
    app's views (1 px of seeded noise), where the app's cache check finds
    them; returns the noiseless projections ``[views, 25, 2]``."""
    rng = np.random.default_rng(seed)
    d = os.path.join(out_dir, RP_SUBJECT, "openpose")
    os.makedirs(d, exist_ok=True)
    clean = []
    for v, w2c in enumerate(w2cs):
        uv = project(joints, np.linalg.inv(w2c), K)
        clean.append(uv)
        kp = np.concatenate([uv + rng.normal(scale=1.0, size=uv.shape),
                             np.ones((len(uv), 1))], 1)
        with open(os.path.join(d, "%02d_keypoints.json" % v), "w") as fh:
            json.dump({"people": [{"pose_keypoints_2d":
                                   kp.reshape(-1).tolist()}]}, fh)
    return np.stack(clean)


def read_rp_outputs(out_dir, size, tasks, debug):
    """Every file the JAX app writes for ``tasks`` (and ``--debug``),
    checked to exist and hold finite values; returns the fit's parameters
    and loss trace."""
    from bodyfitting_torch.io.obj import load_obj
    from bodyfitting_torch.io.params import PARAM_KEYS
    from bodyfitting_torch.io.png import read_png

    sub = os.path.join(out_dir, RP_SUBJECT)
    n, s = size["viewnum"], size["load_size"]
    pngs = {os.path.join(sub, "images", "%02d.png" % i): (s, s, 3)
            for i in range(n)}
    pngs.update({os.path.join(sub, "masks", "%02d.png" % i): (s, s)
                 for i in range(n)})
    objs = []
    if "smplify" in tasks:
        objs += [os.path.join(sub, "smplify", "smpl.obj")]
        if debug:
            pngs[os.path.join(sub, "smplify", "smpl_fitting", "00.png")] = (
                s, s, 3)
        if "smpld" in tasks:
            objs += [os.path.join(sub, "smplify", "smpl+d.obj")]
    if "texfit" in tasks:
        t = os.path.join(sub, "texfit")
        objs += [os.path.join(t, "smpl+d_textured.obj")]
        pngs.update({os.path.join(t, "smpl.png"): (1024, 1024, 3),
                     os.path.join(t, "smpl+d_textured.png"): (1024, 1024, 3),
                     os.path.join(t, "smpl_dis.png"): (1024, 1024, 3)})
        if debug:
            pngs.update({os.path.join(t, "render", "%04d.png" % i):
                         (s, 2 * s, 3) for i in range(36)})
    if "output" in tasks:
        objs += [os.path.join(out_dir, "SMPL", RP_SUBJECT + ".obj")]
        assert os.path.exists(os.path.join(out_dir, "SMPL",
                                           RP_SUBJECT + ".npy"))
    for path, shape in pngs.items():
        assert read_png(path).shape == shape, (path, shape)
    for path in objs:
        m = load_obj(path)
        assert len(m.faces) and np.isfinite(m.verts).all(), path
    params, trace = None, None
    if "smplify" in tasks:
        params = np.load(os.path.join(sub, "smplify", "smpl_parameter.npy"),
                         allow_pickle=True).item()
        assert set(PARAM_KEYS) <= set(params), sorted(params)
        for k, v in params.items():
            assert np.isfinite(v).all(), k
        recs = [json.loads(ln) for ln in
                open(os.path.join(out_dir, "loss_trace.jsonl"))]
        trace = np.asarray(recs[-1]["losses"])
        assert recs[-1]["frame"] == RP_SUBJECT and np.isfinite(trace).all()
    return params, trace


def phase_rp_app(size=RP_APP_PATH, device="cuda", smi="", save_rp=None):
    """The RenderPeople app end to end on a synthetic scan: (a) the scan fit
    with SMPL+D, the texture fit and every output, (b) texfit and output on
    (a)'s caches, (c) the --use_mask scan fit."""
    import tempfile

    import torch

    from bodyfitting_torch.apps import renderpeople as app
    from bodyfitting_torch.fitting import texture as tf
    from bodyfitting_torch.io.png import read_png
    from bodyfitting_torch.models import body_model as bm
    from bodyfitting_torch.models.hmr import seeded_state_dict
    from bodyfitting_torch.ops.nearest import nearest_points
    from bodyfitting_torch.utils.uv_unwrap import per_face_atlas

    on_card = torch.device(device).type == "cuda"
    tmp = tempfile.TemporaryDirectory(prefix="bodyfit_rp_")
    root = tmp.name
    try:
        fixtures = check_jpeg_fixtures()
        # the scan phase's synthetic SMPL as an asset file: the app loads
        # it with the licensed model's joint selectors, so the ground truth
        # is posed with the model as the app loads it
        synth = bm.synthetic_model("smpl", num_verts=size["num_verts"],
                                   mesh="sphere", seed=0, device=device)
        asset = os.path.join(root, "SMPL_NEUTRAL.npz")
        write_smpl_asset(asset, synth)
        ckpt = os.path.join(root, "hmr.pth")
        torch.save(seeded_state_dict(0), ckpt)
        base = ["--target_dir", os.path.join(root, "scans"),
                "--smpl_type", "smpl", "--viewnum", str(size["viewnum"]),
                "--load_size", str(size["load_size"]), "--model_path", asset,
                "--hmr_checkpoint", ckpt]
        model = app.load_body_model(app.config_parser().parse_args(base),
                                    device=device)
        for k in ("v_template", "shapedirs", "posedirs", "J_regressor",
                  "lbs_weights", "faces"):
            assert torch.equal(getattr(model, k), getattr(synth, k)), k
        data = write_rp_scans(root, model, size)
        scan = data["scan"]
        log(f"rp app: scan {len(scan.verts)} vertices {len(scan.faces)} faces "
            f"({data['obj_mib']:.1f} MiB OBJ written in {data['write_s']:.3f} "
            f"s); OBJ parse {data['parse_s'] * 1e3:.1f} ms, 2048^2 JPEG "
            f"decode {data['decode_s'] * 1e3:.1f} ms (host clock, {smi})")
        # the app's ring views of the scan it loads
        center, _, dist = tf.scene_bounds(scan.verts)
        w2cs = tf.ring_poses(center, size["viewnum"], dist)
        K = tf.default_K(size["load_size"])
        texfit = ["--auto_uv", "--inpaint", "--disp_map", "--debug",
                  "--timing", "--tex_iters", str(size["tex_iters"])]
        n_uniq = len(np.unique(tf.training_pose_schedule(
            tf.TextureFitConfig(iter_num=size["tex_iters"]), center,
            dist).reshape(size["tex_iters"], -1), axis=0))
        n_vol = -(-96 ** 3 // 65536)
        post_gate = size["mask_iters"] - size["mask_iters"] // 3 - 1
        out_a, out_c = (os.path.join(root, n) for n in ("out_a", "out_c"))
        plan = (
            ("a", out_a, ["--tasks", "smplify", "smpld", "texfit", "output",
                          "--num_iters", str(size["num_iters"])] + texfit,
             dict(nearest_d2_idx=n_vol,
                  rasterize_zbuf=size["viewnum"] + 1 + 2 * 36,
                  rasterize_attrs=2 * n_uniq)),
            ("b", out_a, ["--tasks", "texfit", "output"] + texfit,
             dict(nearest_d2_idx=0, rasterize_zbuf=1 + 2 * 36,
                  rasterize_attrs=2 * n_uniq)),
            # (a)'s fit again in a fresh directory: SMPL+D sums in a fixed
            # order, so its parameters are (a)'s bit for bit
            ("a2", os.path.join(root, "out_a2"),
             ["--tasks", "smplify", "smpld", "--num_iters",
              str(size["num_iters"])],
             dict(nearest_d2_idx=n_vol, rasterize_zbuf=size["viewnum"])),
            ("c", out_c, ["--use_mask", "--tasks", "smplify", "--num_iters",
                          str(size["mask_iters"])],
             dict(nearest_d2_idx=n_vol, rasterize_zbuf=size["viewnum"],
                  bilinear_cov_grads=2 * post_gate,
                  contour_match_full=post_gate, rows_scatter_add=post_gate)),
        )
        clean = {}
        runs = {}
        captured = {}      # run (c)'s last silhouette kernel calls
        volumes = []       # run (c)'s distance volume

        def keep_last(kernel, fn):
            def wrapped(*a, **kw):
                key = kernel
                if kernel == "bilinear_cov_grads":
                    key = "stay-inside" if kw["with_grads"] else "lookup"
                captured[key] = (tuple(x.detach() if torch.is_tensor(x)
                                       else x for x in a), kw)
                return fn(*a, **kw)
            return wrapped

        for name, out, extra, expect in plan:
            if out not in clean:
                clean[out] = write_rp_keypoints(out, data["joints"], w2cs, K)
            smpl_png = os.path.join(out, RP_SUBJECT, "texfit", "smpl.png")
            before = (open(smpl_png, "rb").read() if os.path.exists(smpl_png)
                      else None)
            argv = base + ["--output_dir", out] + extra
            with (silhouette_ops(keep_last) if name == "c"
                  else contextlib.nullcontext()), \
                    (keep_volume(volumes) if name == "c"
                     else contextlib.nullcontext()):
                wall, counts, runner = run_app(argv, device, app)
            tasks = extra[extra.index("--tasks") + 1:]
            tasks = tasks[:next((i for i, t in enumerate(tasks)
                                 if t.startswith("--")), len(tasks))]
            params, trace = read_rp_outputs(out, size, tasks,
                                            "--debug" in extra)
            assert runner.model is model
            expect = {k: expect.get(k, 0) for k in counts}
            log(f"rp app run ({name}): tasks {' '.join(tasks)}; {wall:.3f} s "
                f"wall; stages (s) {json.dumps(runner.timings[RP_SUBJECT])}; "
                f"launches {counts} (expected {expect}); {smi}")
            if on_card:
                assert counts == expect, (name, counts, expect)
            r = dict(wall=wall, counts=counts, timing=runner.timings[
                RP_SUBJECT])
            if params is not None:
                r["trace"] = trace
                r["params_sha1"] = params_sha1({0: params})
                log(f"rp app run ({name}): fitted parameters sha1 "
                    f"{r['params_sha1']}; loss first / last {trace[0]:.3f} / "
                    f"{trace[-1]:.3f} over {len(trace)} steps")
                px = np.linalg.norm(np.stack([
                    project(params["joints"][:25], np.linalg.inv(w2c), K)
                    for w2c in w2cs]) - clean[out], axis=-1).mean()
                r["px"] = float(px)
            if name == "b":
                after = open(smpl_png, "rb").read()
                r["smpl_png_equal"] = after == before
                log(f"rp app run (b): texfit/smpl.png equals run (a)'s byte "
                    f"for byte: {r['smpl_png_equal']} "
                    f"(sha1 {hashlib.sha1(after).hexdigest()})")
                assert r["smpl_png_equal"], "run (b)'s texture differs"
            runs[name] = r

        if save_rp:
            save_rp_inputs(save_rp, data["arrays"], out_c, size,
                           volumes[-1])
        log(f"rp app run (a2): the smplify and smpld tasks of (a) rerun: "
            f"parameters sha1 {runs['a2']['params_sha1']} (run (a): "
            f"{runs['a']['params_sha1']})")
        assert runs["a2"]["params_sha1"] == runs["a"]["params_sha1"], \
            "SMPL+D is not repeatable"
        # run (a)'s fit against the ground truth and the scan
        pa = np.load(os.path.join(out_a, RP_SUBJECT, "smplify",
                                  "smpl_parameter.npy"),
                     allow_pickle=True).item()
        dev = torch.device(device)
        sv_t = torch.as_tensor(scan.verts, device=dev)
        sf_t = torch.as_tensor(scan.faces.astype(np.int64), device=dev)
        smpld = pa["vertices"] + pa["displacement"]
        # the vertex normals and their gradient, twice, bitwise
        from bodyfitting_torch.losses.mesh import (
            compute_vertex_normals, normal_laplacian_smoothness)

        twice = []
        for _ in range(2):
            v = torch.as_tensor(smpld, device=dev).requires_grad_(True)
            vn = compute_vertex_normals(v, model.faces)
            loss = vn.sum() + normal_laplacian_smoothness(vn, model.faces)
            twice.append((vn.detach(), torch.autograd.grad(loss, [v])[0]))
        same = all(torch.equal(a, b) for a, b in zip(*twice))
        log(f"rp app: compute_vertex_normals and the smoothness term on "
            f"(a)'s SMPL+D ({len(smpld)} vertices), value and gradient, two "
            f"calls bitwise equal: {same} (tol: exact)")
        assert same, "vertex normals differ from call to call"
        if on_card:
            log(f"rp app: normals and smoothness, forward and backward: "
                f"{normals_ms(v.detach(), model.faces, ordered=True):.3f} "
                f"ms in a fixed order, "
                f"{normals_ms(v.detach(), model.faces, ordered=False):.3f} "
                f"ms through index_add (atomics; host clock, 20 calls)")
        mm = {}
        for what, v in (("body", pa["vertices"]), ("SMPL+D", smpld)):
            vt = torch.as_tensor(v, device=dev)
            closest, _ = nearest_points(vt, sv_t, sf_t)
            mm[what] = float((vt - closest).norm(dim=1).mean()) * 1e3
        for name in ("a", "c"):
            log(f"rp app run ({name}): fitted joints reproject "
                f"{runs[name]['px']:.3f} px from the ground truth's keypoints "
                f"on average (bound {size['max_px']} px)")
        log(f"rp app run (a): mean distance to the scan {mm['body']:.3f} mm "
            f"for the body, {mm['SMPL+D']:.3f} mm for SMPL+D (bound "
            f"{size['max_mm']} mm)")
        assert runs["a"]["px"] <= size["max_px"], runs["a"]["px"]
        # run (c): the mask term is live after the gate
        gate = size["mask_iters"] // 3
        tc = runs["c"]["trace"]
        log(f"rp app run (c): loss at the gate / after it / last "
            f"{tc[gate]:.1f} / {tc[gate + 1]:.1f} / {tc[-1]:.1f} (the mask "
            f"and point-to-scan terms start after step {gate})")
        assert tc[gate + 1] > tc[gate], "mask term not live"
        # the silhouette kernels at the inputs of run (c)'s last step: full
        # f32 masks with coverage, the app's contour and vertex counts
        silhouette = {}
        if on_card:
            silhouette = {r["name"]: r for r in (
                check_bilinear_full(captured),
                check_contour(captured["contour_match_full"][0],
                              edge_cases=False),
                check_scatter(captured["rows_scatter_add"][0],
                              edge_cases=False))}
        assert mm["SMPL+D"] <= size["max_mm"], mm
        # the fitted texture against grey on the 18 ring views
        cfg = tf.TextureFitConfig(iter_num=size["tex_iters"])
        ring = tf.training_pose_schedule(cfg, center, dist)[:cfg.round_views]
        suv, sfu = per_face_atlas(len(model.faces))
        scene = (sv_t, sf_t, torch.as_tensor(scan.uvs[scan.face_uvs],
                                             device=dev),
                 torch.as_tensor(scan.texture, device=dev),
                 torch.as_tensor(smpld, device=dev), model.faces.long(),
                 torch.as_tensor(suv[sfu], device=dev))
        maps = tf.texture_maps(torch.as_tensor(ring.astype(np.float32),
                                               device=dev),
                               torch.as_tensor(tf.default_K(
                                   cfg.render_img_size), device=dev),
                               scene, cfg.render_img_size)
        fitted = torch.as_tensor(read_png(os.path.join(
            out_a, RP_SUBJECT, "texfit", "smpl.png")).astype(np.float32)
            / 255.0, device=dev)
        grey = torch.full_like(fitted, 128.0 / 255.0)
        l1 = [sum(float(tf.maps_loss(t, *(m[k] for m in maps)))
                  for k in range(len(ring))) for t in (grey, fitted)]
        log(f"rp app run (a): ring-view L1 over {len(ring)} views: grey "
            f"texture {l1[0]:.1f}, fitted {l1[1]:.1f}")
        assert l1[1] < l1[0], "the fitted texture is no closer than grey"
        return dict(runs=runs, mm=mm, l1=l1, fixtures=fixtures,
                    silhouette=silhouette,
                    scan=dict(faces=len(scan.faces), parse_s=data["parse_s"],
                              decode_s=data["decode_s"],
                              write_s=data["write_s"]))
    finally:
        tmp.cleanup()


# ---------------------------------------------------------------------------
# Phase 11: the native OpenPose detector in the GeneBody app; fit_resumable
# ---------------------------------------------------------------------------

# Two frames of phase 9's synthetic subject (48 ring views at 2448 x 2048,
# an RGB image for every view) through --native_openpose at --load_size
# 512, with the detector's own scales: the body at 0.5-2.0 x 368 / 512,
# each hand crop at four scales, the face at 368^2.
OPENPOSE_PATH = dict(APP_PATH, frames=2, fit_iters=60, cpu_views=2,
                     peaks_per_part=2, body_scales=(0.5, 1.0, 1.5, 2.0),
                     hand_scales=(0.5, 1.0, 1.5, 2.0), boxsize=368,
                     face_boxsize=368, chunk=100,
                     # hand and face crop maps of (a) held card vs host in
                     # (b), of each kind (those with a confident point)
                     crop_checks=3,
                     # masks dilated to a filled body: the app keeps only
                     # the image's masked pixels
                     mask_dilate=6,
                     # card vs CPU on the body maps at scale 0.5, of the
                     # maps' largest magnitude: TF32 convolutions (the
                     # default; measured 3.8e-3) and float32 ones (1.8e-5)
                     tol_tf32=2e-2, tol_fp32=1e-4)
H100_TF32_FLOPS_PER_S = 495e12   # dense TF32 tensor cores, data sheet

# An upright COCO-18 stick figure (image coordinates, y down): each limb's
# direction, which the seeded PAF heads are set to point along.
SKELETON = {0: (0, -42), 1: (0, -30), 2: (-12, -30), 3: (-16, -12),
            4: (-18, 4), 5: (12, -30), 6: (16, -12), 7: (18, 4),
            8: (-8, 0), 9: (-9, 20), 10: (-10, 40), 11: (8, 0),
            12: (9, 20), 13: (10, 40), 14: (-4, -45), 15: (4, -45),
            16: (-9, -43), 17: (9, -43)}


@functools.lru_cache(maxsize=None)
def net_flops(kind, h, w):
    """Operations (2 per multiply-add) of one pass of the ``kind`` OpenPose
    net on an ``h x w`` input, counted over its convolutions' shapes in a
    forward on the meta device."""
    import torch

    from bodyfitting_torch.models import openpose as op

    net = op.net_structure(kind)
    total = [0]

    def hook(mod, inp, out):
        k = mod.kernel_size[0] * mod.kernel_size[1]
        total[0] += 2 * out.numel() * mod.in_channels * k

    for m in net.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(hook)
    net(torch.empty((1, 3, h, w), device="meta"))
    return total[0]


def padded_hw(hw, scale, stride=8):
    """The net's input size for an image of ``hw`` at ``scale``: OpenCV's
    ``round(src * scale)``, padded up to the stride."""
    return tuple(-(-int(round(n * scale)) // stride) * stride for n in hw)


def _median_over_views(x):
    return x.median(dim=0).values.double().cpu().numpy()


def calibrate_openpose(images, ckpt_dir, device, size, seed=0):
    """Seeded weights of the three nets in the released flat layout,
    written to ``ckpt_dir``, with the last stage's heads set channel by
    channel (an affine map of each output channel: its kernel row scaled,
    its bias set) so that, on ``images`` (uint8 BGR crops of one frame):
    each body part's smoothed heatmap has a median of ``peaks_per_part``
    local maxima above the 0.1 threshold and its strongest peak at 0.6;
    each PAF channel has the direction of its limb in :data:`SKELETON` as
    its mean and 0.3 as its spread; each hand and face part is above the
    0.05 blob threshold at its top 0.1 % of pixels and peaks at 0.4.
    Random nets give maps of arbitrary scale and thousands of peaks."""
    import torch

    from bodyfitting_torch.models import openpose as op
    from bodyfitting_torch.models import openpose_infer as opi

    k = size["peaks_per_part"]
    imgs = torch.as_tensor(np.stack(images)).to(device)
    nets, sds, out = {}, {}, {}

    def affine(sd, layer, a, b):
        a = torch.as_tensor(a, dtype=torch.float32)
        sd[layer + ".weight"] = sd[layer + ".weight"] * a[:, None, None, None]
        sd[layer + ".bias"] = sd[layer + ".bias"] * a + torch.as_tensor(
            b, dtype=torch.float32)

    for i, kind in enumerate(("body", "hand", "face")):
        sds[kind] = op.seeded_state_dict(kind, seed + i)
        nets[kind] = getattr(op, f"load_{kind}_net")(None, device, seed + i)
    paf, heat = opi.multiscale_maps_batch(nets["body"], imgs, [38, 19],
                                          boxsize=size["boxsize"],
                                          scales=size["body_scales"])
    tops = []
    for c0 in range(0, len(imgs), 8):
        sm = opi.gaussian_smooth(heat[c0:c0 + 8, :18])
        loc = torch.where(opi._peak_mask(sm, -float("inf")), sm,
                          torch.full_like(sm, -float("inf")))
        tops.append(loc.flatten(2).topk(k + 1, dim=2).values)
    tops = torch.cat(tops)                                  # [N, 18, k+1]
    v1 = _median_over_views(tops[:, :, 0])
    mid = 0.5 * (_median_over_views(tops[:, :, k - 1])
                 + _median_over_views(tops[:, :, k]))
    a = np.ones(19)
    b = np.zeros(19)
    a[:18] = 0.5 / (v1 - mid)
    b[:18] = 0.1 - a[:18] * mid
    affine(sds["body"], "Mconv7_stage6_L2", a, b)
    flat = paf.transpose(0, 1).reshape(38, -1)
    mean = flat.mean(1).double().cpu().numpy()
    std = flat.std(1).double().cpu().numpy()
    target = np.zeros(38)
    for (pa, pb), (mx, my) in zip(opi.LIMB_SEQ, opi.MAP_IDX):
        d = np.subtract(SKELETON[pb - 1], SKELETON[pa - 1]).astype(float)
        target[[mx - 19, my - 19]] = d / np.linalg.norm(d)
    a = 0.3 / std
    affine(sds["body"], "Mconv7_stage6_L1", a, target - a * mean)
    out["body"] = dict(heat_scale=[float(x) for x in (a.min(), a.max())])
    del paf, heat, tops
    for kind, n_out, box in (("hand", 22, size["boxsize"]),
                             ("face", 71, size["face_boxsize"])):
        (hm,) = opi.multiscale_maps_batch(nets[kind], imgs[:4], [n_out],
                                          boxsize=box, scales=(1.0,))
        flat = hm.transpose(0, 1).reshape(n_out, -1)
        q = flat.kthvalue(int(0.999 * flat.shape[1]), dim=1).values
        top = flat.max(1).values
        q, top = q.double().cpu().numpy(), top.double().cpu().numpy()
        a = 0.35 / (top - q)
        b = 0.05 - a * q
        a[-1], b[-1] = 1.0, 0.0                     # background
        affine(sds[kind], "Mconv7_stage6", a, b)
    os.makedirs(ckpt_dir, exist_ok=True)
    for kind in sds:
        torch.save(sds[kind], os.path.join(ckpt_dir,
                                           f"{kind}_pose_model.pth"))
    return out


def _openpose_outputs(out_dir, frames):
    """One parseable JSON per view image of each frame, read back by the
    port's ``load_openpose``: per frame the views, people and the hand and
    face blocks with a confident point."""
    from bodyfitting_torch.io.openpose import load_openpose

    counts = {}
    for f in frames:
        frame_dir = os.path.join(out_dir, SUBJECT, "%06d" % f)
        stems = sorted(n[:-4] for n in os.listdir(os.path.join(
            frame_dir, "images")) if n.endswith(".png"))
        assert sorted(n[:-len("_keypoints.json")] for n in os.listdir(
            os.path.join(frame_dir, "openpose"))) == stems, f
        people = hands = faces = views = 0
        for stem in stems:
            path = os.path.join(frame_dir, "openpose",
                                f"{stem}_keypoints.json")
            doc = json.load(open(path))
            assert doc["version"] == 1.3, path
            people += len(doc["people"])
            for person in doc["people"]:
                assert len(person["pose_keypoints_2d"]) == 75
                for key, n in (("hand_left_keypoints_2d", 63),
                               ("hand_right_keypoints_2d", 63),
                               ("face_keypoints_2d", 210)):
                    block = np.asarray(person[key])
                    assert block.shape == (n,) and np.isfinite(block).all()
                    if (block[2::3] > 0).any():
                        if key.startswith("hand"):
                            hands += 1
                        else:
                            faces += 1
            kp = load_openpose(path)
            views += kp is not None
        counts[f] = dict(views=len(stems), people=people,
                         views_with_people=views, hands=hands, faces=faces)
    return counts


def phase_openpose(state, size=OPENPOSE_PATH, device="cuda", smi=""):
    """Phase 11: (a) ``--tasks openpose --native_openpose`` on 2 frames x
    48 views with seeded, calibrated checkpoints, then warm passes without
    and with ``Stats``; (b) the body maps card vs CPU, the card's peaks and
    people and (a)'s hand and face crop peaks vs the host path; (c) ``--tasks
    smplify output`` on (a)'s JSONs; (d) ``fit_resumable`` on phase 3's
    problem, stopped past the gate and resumed, against phase 3's fit."""
    import tempfile

    import torch

    from bodyfitting_torch.apps import genebody as app
    from bodyfitting_torch.fitting import checkpointing as ck
    from bodyfitting_torch.fitting import smplify
    from bodyfitting_torch.models import openpose as op
    from bodyfitting_torch.models import openpose_infer as opi

    on_card = torch.device(device).type == "cuda"
    tmp = tempfile.TemporaryDirectory(prefix="bodyfit_openpose_")
    root = tmp.name
    tf32_before = torch.backends.cudnn.allow_tf32
    frames = list(range(size["frames"]))
    try:
        torch.backends.cudnn.allow_tf32 = CUDNN_TF32_DEFAULT
        log(f"openpose: torch.backends.cudnn.allow_tf32 = "
            f"{torch.backends.cudnn.allow_tf32} (PyTorch's default; the "
            f"package sets no precision flag); {smi}")
        argv0 = ["--smpl_type", "smplx", "--subject", SUBJECT,
                 "--load_size", str(size["load_size"]),
                 "--synthetic_num_verts", str(size["num_verts"])]
        model = app.load_body_model(app.config_parser().parse_args(argv0),
                                    device=device)
        write_genebody_subject(root, model, size, all_images=True)
        target = os.path.join(root, "genebody")
        argv0 += ["--target_dir", target]
        # calibration on frame 0's crops, as the app makes them (the
        # detector reads the PNGs it writes: BGR)
        calib = app.Runner(app.config_parser().parse_args(
            argv0 + ["--output_dir", os.path.join(root, "calib")]), device)
        crops = [np.ascontiguousarray(im[..., ::-1])
                 for im in calib.get_data(frames[0])[0]]
        ckpt_dir = os.path.join(root, "openpose_ckpt")
        t0 = time.perf_counter()
        calibrate_openpose(crops, ckpt_dir, device, size)
        log(f"openpose: seeded checkpoints calibrated on {len(crops)} crops "
            f"of {crops[0].shape} and written in "
            f"{time.perf_counter() - t0:.2f} s")

        # (a) detection through the app
        out = os.path.join(root, "out")
        args = app.config_parser().parse_args(argv0 + [
            "--output_dir", out, "--tasks", "openpose", "--native_openpose",
            "--openpose_ckpt_dir", ckpt_dir, "--timing"])
        runner = app.Runner(args, device)
        runner._init_native_detectors()
        body, hand, face = runner._native_detectors
        stats = opi.Stats()
        body.scales, body.boxsize = size["body_scales"], size["boxsize"]
        hand.scales = size["hand_scales"]
        face.boxsize = size["face_boxsize"]
        for det in (body, hand, face):
            det.stats = stats
        per_frame = []
        orig = opi.detect_to_json
        crop_peaks = opi._crop_peaks_device
        crop_maps = {"hand": [], "face": []}

        def timed_detect(*a, **kw):
            t = time.perf_counter()
            orig(*a, **kw)
            per_frame.append(time.perf_counter() - t)

        def keep_crop_maps(heat, n_parts, thre, stats=None):
            # (b) holds the card's crop peaks to the host's on these maps
            res = crop_peaks(heat, n_parts, thre, stats)
            kept = crop_maps["hand" if n_parts == 21 else "face"]
            if len(kept) < size["crop_checks"] and res[:, 2].any():
                kept.append((heat, n_parts, thre))
            return res
        opi.detect_to_json = timed_detect
        opi._crop_peaks_device = keep_crop_maps
        try:
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            sync(device)
            t0 = time.perf_counter()
            runner.run()
            sync(device)
            wall = time.perf_counter() - t0
        finally:
            opi.detect_to_json = orig
            opi._crop_peaks_device = crop_peaks
        peak = (f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
                if on_card else "not measured")
        counts = _openpose_outputs(out, frames)
        timing = json.load(open(os.path.join(out, SUBJECT, "timing.json")))
        flops = {kind: sum(n * net_flops(kind, ph, pw)
                           for n, ph, pw in stats.inputs.get(kind, []))
                 for kind in ("body", "hand", "face")}
        secs = {kind: sum(v for k, v in stats.seconds.items()
                          if k.startswith(kind + "/scale"))
                for kind in flops}
        det_s = float(np.mean(per_frame))
        total_flop = sum(flops.values())
        log(f"openpose (a): {len(frames)} frames x 48 views in {wall:.3f} s "
            f"wall; detector {det_s:.3f} s a frame (detect_to_json, inside "
            f"the detector lock: {', '.join(f'{x:.3f}' for x in per_frame)}"
            f"); timing.json prep/openpose {json.dumps(timing.get('prep/openpose'))}"
            f" (with --prep_workers 2 a frame's stage includes its wait for "
            f"the other frame's detection); peak device memory {peak}")
        log(f"openpose (a) outputs per frame: {json.dumps(counts)}")
        log(f"openpose (a) FLOP a frame: " + ", ".join(
            f"{k} {flops[k] / len(frames) / 1e12:.3f} T" for k in flops)
            + f"; total {total_flop / len(frames) / 1e12:.3f} TFLOP a frame, "
            f"{total_flop / len(frames) / det_s / 1e12:.1f} TFLOP/s over the "
            f"detector's seconds")
        for kind in flops:
            if secs[kind] > 0:
                log(f"openpose (a) {kind} net passes (resizes included): "
                    f"{secs[kind]:.3f} s, {flops[kind] / secs[kind] / 1e12:.1f}"
                    f" TFLOP/s = {flops[kind] / secs[kind] / H100_TF32_FLOPS_PER_S:.3f}"
                    f" of the TF32 peak, "
                    f"{flops[kind] / secs[kind] / F32_FLOPS_PER_S:.3f} of the "
                    f"FP32 peak")
        log("openpose (a) parts: " + "; ".join(
            f"{k} {v * 1e3:.1f} ms / {stats.calls[k]} calls"
            + (f" / {stats.items[k]} images" if stats.items[k] else "")
            for k, v in sorted(stats.seconds.items())))
        host_s = stats.seconds.get("body/assembly", 0.0) + sum(
            v for k, v in stats.seconds.items() if k.endswith("/peaks"))
        log(f"openpose (a) host share: body assembly "
            f"{stats.seconds.get('body/assembly', 0.0):.3f} s + peak "
            f"extraction with its labelling {host_s - stats.seconds.get('body/assembly', 0.0):.3f} s"
            f" of {sum(per_frame):.3f} s detection; "
            f"{stats.bytes_to_host / 2**20:.1f} MiB copied to the host")
        for kind, ins in stats.inputs.items():
            log(f"openpose (a) {kind} net inputs (batch, H, W), first 12 of "
                f"{len(ins)}: {ins[:12]}")
        assert all(c["views_with_people"] > 0 for c in counts.values()), counts
        assert stats.calls.get("hand/peaks", 0) > 0, "no hand crop detected"
        assert stats.calls.get("face/peaks", 0) > 0, "no face crop detected"

        # the same detection as users run it, without Stats (whose parts
        # drain the device at both ends), and again with Stats: warm passes
        # of the app's _native_detect over (a)'s frames, each into a
        # directory of its own
        warm = {}
        for mode in ("plain", "stats"):
            warm_stats = opi.Stats() if mode == "stats" else None
            for det in (body, hand, face):
                det.stats = warm_stats
            for f in frames:
                frame_dir = os.path.join(out, SUBJECT, "%06d" % f)
                sync(device)
                t0 = time.perf_counter()
                runner._native_detect(os.path.join(frame_dir, "images"),
                                      os.path.join(root, mode, str(f)))
                sync(device)
                warm.setdefault(mode, []).append(time.perf_counter() - t0)
        warm_host = warm_stats.seconds.get("body/assembly", 0.0) + sum(
            v for k, v in warm_stats.seconds.items() if k.endswith("/peaks"))
        log(f"openpose (a) warm passes: detector without Stats "
            f"{float(np.mean(warm['plain'])):.3f} s a frame (frames "
            f"{', '.join(f'{x:.3f}' for x in warm['plain'])}), with Stats "
            f"{float(np.mean(warm['stats'])):.3f} s (frames "
            f"{', '.join(f'{x:.3f}' for x in warm['stats'])}; host assembly "
            f"and peak extraction {warm_host:.3f} s of "
            f"{sum(warm['stats']):.3f} s)")

        # the body pass at 368^2 (scale 1.0) on the frame's views, TF32 on
        # (the default) and off
        imgs = torch.as_tensor(np.stack(crops)).to(device)

        def body_pass():
            opi.multiscale_maps_batch(body.net, imgs, [38, 19],
                                      boxsize=size["boxsize"], scales=(1.0,))
        tf32 = {}
        for flag in (True, False, True):
            torch.backends.cudnn.allow_tf32 = flag
            body_pass()
            sync(device)
            t0 = time.perf_counter()
            body_pass()
            sync(device)
            tf32.setdefault(flag, []).append(time.perf_counter() - t0)
        torch.backends.cudnn.allow_tf32 = CUDNN_TF32_DEFAULT
        fl = len(crops) * net_flops("body", *padded_hw(
            crops[0].shape[:2], size["boxsize"] / crops[0].shape[0]))
        log(f"openpose: body pass at scale 1.0, {len(crops)} views: TF32 "
            f"{[f'{x * 1e3:.1f}' for x in tf32[True]]} ms, FP32 "
            f"{[f'{x * 1e3:.1f}' for x in tf32[False]]} ms "
            f"({fl / min(tf32[True]) / 1e12:.1f} vs "
            f"{fl / min(tf32[False]) / 1e12:.1f} TFLOP/s)")

        # (b) card vs CPU on two views
        two = crops[:size["cpu_views"]]
        cpu_net = op.load_body_net(os.path.join(ckpt_dir,
                                                "body_pose_model.pth"), "cpu")
        cpu_maps = opi.multiscale_maps_batch(
            cpu_net, torch.as_tensor(np.stack(two)), [38, 19],
            boxsize=size["boxsize"], scales=(0.5,))
        for flag, tol in ((True, size["tol_tf32"]),
                          (False, size["tol_fp32"])):
            torch.backends.cudnn.allow_tf32 = flag
            card = opi.multiscale_maps_batch(
                body.net, imgs[:len(two)], [38, 19], boxsize=size["boxsize"],
                scales=(0.5,))
            for name, c, r in zip(("paf_avg", "heatmap_avg"), card, cpu_maps):
                err = float((c.cpu() - r).abs().max())
                scale = float(r.abs().max())
                log(f"openpose (b) {name} at scale 0.5, card (cudnn TF32 "
                    f"{flag}) vs CPU: max abs err {err:.3e}, max relative "
                    f"err {err / scale:.3e} of the map's largest magnitude "
                    f"{scale:.3e} (tolerance {tol:g})")
                assert err <= tol * scale, (name, flag, err, scale)
        torch.backends.cudnn.allow_tf32 = CUDNN_TF32_DEFAULT
        paf, heat = body.maps(imgs[:len(two)])
        peaks = opi.find_peaks_batch(heat)
        people = opi.assemble_people_batch(peaks, paf, two[0].shape[0])
        heat_np = heat.permute(0, 2, 3, 1).cpu().numpy()
        paf_np = paf.permute(0, 2, 3, 1).cpu().numpy()
        for n in range(len(two)):
            host = opi.find_peaks(heat_np[n])
            assert peaks[n] == host, f"peaks differ on view {n}"
            cand, subset = opi.assemble_people(host, paf_np[n],
                                               two[0].shape[0])
            assert np.array_equal(people[n][0], cand)
            assert np.array_equal(people[n][1], subset)
        log(f"openpose (b): the card's peaks and people equal the host "
            f"path's on the card's maps ({[sum(map(len, p)) for p in peaks]}"
            f" peaks, {[len(p[1]) for p in people]} people)")
        # the hand and face crops' peaks: smoothing and threshold on the
        # card against scipy's gaussian_filter on the same maps on the host
        hits = {}
        for kind, kept in crop_maps.items():
            assert kept, f"no {kind} crop with a confident point in (a)"
            hits[kind] = []
            for heat_c, n_parts, thre in kept:
                card = opi._crop_peaks_device(heat_c, n_parts, thre)
                host = opi._crop_peaks_with_scores(
                    heat_c.permute(1, 2, 0).cpu().numpy(), n_parts, thre)
                assert np.array_equal(card, host), \
                    f"{kind} crop peaks differ on {tuple(heat_c.shape)}"
                hits[kind].append((tuple(heat_c.shape[1:]),
                                   int((host[:, 2] > 0).sum())))
        log(f"openpose (b): the card's hand and face crop peaks equal the "
            f"host's (scipy) on (a)'s crop maps ((H, W), parts found): "
            f"{json.dumps(hits)}")
        torch.backends.cudnn.allow_tf32 = tf32_before

        # (c) the fit on (a)'s JSONs
        wall_c, _, _ = run_app(argv0 + [
            "--output_dir", out, "--tasks", "smplify", "output",
            "--num_iters", str(size["fit_iters"])], device)
        params, trace, _ = read_app_outputs(out, frames)
        for f, tr in trace.items():
            assert np.isfinite(tr).all(), f
        log(f"openpose (c): --tasks smplify output, {size['fit_iters']} "
            f"iterations on (a)'s JSONs: {wall_c:.3f} s wall; loss "
            + ", ".join(f"frame {f} {tr[0]:.1f} -> {tr[-1]:.1f}"
                        for f, tr in sorted(trace.items())))

        # (d) fit_resumable on phase 3's problem
        config, chunk = state["config"], size["chunk"]
        gate = config.num_iters // config.stage_gate_den
        stop = (gate // chunk + 1) * chunk          # a chunk past the gate
        path = os.path.join(root, "fit.ckpt")
        make = smplify.make_step_fn

        class Stopped(Exception):
            pass

        def stopping(*a, **kw):
            step_fn = make(*a, **kw)

            def step(i):
                if i == stop:
                    raise Stopped
                return step_fn(i)
            return step
        ck.smplify.make_step_fn = stopping
        first = None
        try:
            t0 = time.perf_counter()
            ck.fit_resumable(state["model"], config, state["obs"],
                             state["init"], state["prior"], path, chunk)
        except Stopped:
            first = time.perf_counter() - t0
        finally:
            ck.smplify.make_step_fn = make
        assert torch.load(path, weights_only=True)["step"] == stop
        t0 = time.perf_counter()
        params, _, losses = ck.fit_resumable(
            state["model"], config, state["obs"], state["init"],
            state["prior"], path, chunk)
        sync(device)
        second = time.perf_counter() - t0
        assert np.array_equal(losses.cpu().numpy(), state["losses"]), \
            "resumed loss trace differs from the unbroken fit's"
        for a, b in zip(params.tensors(), state["params"].tensors()):
            assert torch.equal(a, b), "resumed parameters differ"
        # the final checkpoint read back onto the card, and written again
        template = ck.FitCheckpoint(
            params=params.tensors(), opt_state=dict(
                mu=params.tensors(), nu=params.tensors(), count=0), step=0)
        sync(device)
        t0 = time.perf_counter()
        saved = ck.load_checkpoint(path, template)
        sync(device)
        load_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        ck.save_checkpoint(os.path.join(root, "again.ckpt"), saved)
        save_ms = (time.perf_counter() - t0) * 1e3
        log(f"openpose (d): fit_resumable in chunks of {chunk}, stopped at "
            f"step {stop} (gate {gate}) after {first:.3f} s and resumed by "
            f"a fresh call ({second:.3f} s): parameters and loss trace "
            f"bitwise equal to phase 3's unbroken fit (sha1 "
            f"{state['digest']}); checkpoint {os.path.getsize(path)} bytes, "
            f"save {save_ms:.2f} ms, load {load_ms:.2f} ms")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32_before
        tmp.cleanup()


# ---------------------------------------------------------------------------
# Phase 12: the rest of the single-device package on the card
# ---------------------------------------------------------------------------

# Phase 12's shapes: (a) validate_assets on an SMPL-X asset of the
# published width (10,475 vertices) and seeded checkpoints in the released
# layouts; (b) phase 6's scan fit on a batch of two scans; (c) the debug
# overlays of phase 9's keypoint fit on its 2448 x 2048 captures; (d) the
# soft silhouette of phase 3's SMPL-X body at 512^2 (the card) and 128^2
# (card vs CPU); (e) inside-mesh and intersects-any of the fitted SMPL's
# vertices against the 219,008-face scan.
PHASE12 = dict(
    smplx_faces=2000, cpu_queries=512, cpu_soft=128, soft=512,
    # scan 0 of the batch against phase 6's one-scan fit, mm: a batch
    # runs the keypoint term's forward at B 2, whose sums round
    # differently from B 1, and the f32 fit amplifies that (2.92 mm on the
    # SDF route and 0.0012 mm on the exact one, NVIDIA H100 80GB HBM3 at
    # 700 W, the first run of this phase)
    max_scan0_mm=5.0,
    # scan 1's mean distances to its scan against phase 6's: within this
    # fraction of them
    band=0.25,
    # (d) on the card against the CPU at 128^2: coverage (absolute) and
    # the vertex gradient (of its largest entry); other summation orders
    # and CUDA's exp/log1p
    soft_cov_tol=1e-4, soft_grad_tol=1e-3,
    # (c) the card against the CPU on one view at 1/4 size: at most 1
    # level, at no more than this share of the pixels
    overlay_share=1e-3)

SMPLX_PARENTS = ([-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14,
                  16, 17, 18, 19] + [15, 15, 15]
                 + [20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 20, 37,
                    38]
                 + [21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52,
                    53])


def write_smplx_asset(path, n_faces=2000, break_weights=False, seed=0):
    """A seeded SMPL-X ``.npz`` of the published width (10,475 vertices,
    55 joints, 400 shape directions, the hand PCA and landmark tables),
    as ``tests/test_validate_assets.py`` writes it; ``break_weights``
    scales the skinning weights by 1.5 (their rows no longer sum to 1)."""
    J, V = 55, 10475
    rng = np.random.default_rng(seed)
    parents = np.asarray(SMPLX_PARENTS, np.int64)
    kintree = np.stack([parents, np.arange(J)], 0).astype(np.uint32)
    kintree[0, 0] = np.iinfo(np.uint32).max
    F = n_faces
    fa = rng.integers(0, V, size=F)
    fb = (fa + 1 + rng.integers(0, V - 1, size=F)) % V
    fc = (fa + 2 + rng.integers(0, V - 2, size=F)) % V
    fc = np.where(fc == fb, (fc + 1) % V, fc)
    fc = np.where(fc == fa, (fc + 1) % V, fc)
    fc = np.where(fc == fb, (fc + 1) % V, fc)
    weights = rng.dirichlet(np.ones(J), size=V)
    if break_weights:
        weights = weights * 1.5
    np.savez(
        str(path),
        v_template=rng.normal(scale=0.3, size=(V, 3)),
        shapedirs=rng.normal(scale=0.01, size=(V, 3, 400)),
        posedirs=rng.normal(scale=1e-3, size=(V, 3, (J - 1) * 9)),
        J_regressor=rng.dirichlet(np.ones(V) * 0.05, size=J),
        weights=weights, kintree_table=kintree,
        f=np.stack([fa, fb, fc], 1).astype(np.uint32),
        hands_componentsl=rng.normal(size=(45, 45)),
        hands_componentsr=rng.normal(size=(45, 45)),
        hands_meanl=rng.normal(scale=0.05, size=45),
        hands_meanr=rng.normal(scale=0.05, size=45),
        lmk_faces_idx=rng.integers(0, F, size=51).astype(np.int64),
        lmk_bary_coords=rng.dirichlet(np.ones(3), size=51),
        dynamic_lmk_faces_idx=rng.integers(0, F, size=(79, 17)).astype(
            np.int64),
        dynamic_lmk_bary_coords=rng.dirichlet(np.ones(3), size=(79, 17)))


def write_gmm_asset(path, K=8, D=69, seed=1):
    """A seeded ``gmm_08.pkl`` (means, covariances, weights)."""
    import pickle

    rng = np.random.default_rng(seed)
    covs = []
    for _ in range(K):
        A = rng.normal(size=(D, D)) * 0.03
        covs.append(A @ A.T + np.eye(D) * 0.2)
    with open(path, "wb") as f:
        pickle.dump({"means": rng.normal(scale=0.2, size=(K, D)),
                     "covars": np.stack(covs),
                     "weights": rng.dirichlet(np.ones(K))}, f)


def write_checkpoints(root):
    """Seeded HMR, OpenPose body / hand / face and LBAM checkpoints in the
    released layouts; returns ``{flag: path}`` and the write seconds."""
    import torch

    from bodyfitting_torch.models import hmr, inpaint, openpose

    t0 = time.perf_counter()
    paths = {"--hmr": os.path.join(root, "model_checkpoint.pt")}
    torch.save({"model": hmr.seeded_state_dict(0)}, paths["--hmr"])
    for kind in ("body", "hand", "face"):
        path = os.path.join(root, f"{kind}_pose_model.pth")
        torch.save(openpose.seeded_state_dict(kind, 0), path)
        paths[f"--openpose_{kind}"] = path
    paths["--lbam"] = os.path.join(root, "LBAM_NoBN_ParisStreetView.pth")
    torch.save({k: torch.from_numpy(v)
                for k, v in inpaint.seeded_state_dict(0).items()},
               paths["--lbam"])
    return paths, time.perf_counter() - t0


def run_validate(va, argv, device):
    """``validate_assets.main(argv)`` with its report's rows kept and each
    ``validate_*`` check timed: ``(rc, rows, seconds by check)``."""
    rows, secs = [], {}
    orig_dump = va.Report.dump

    def dump(self):
        rows.extend(self.rows)
        orig_dump(self)

    names = ("validate_model", "validate_gmm", "validate_hmr",
             "validate_openpose", "validate_lbam")
    originals = {n: getattr(va, n) for n in names}

    def timed(name, fn):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            sync(device)
            key = name[len("validate_"):]
            if name == "validate_openpose":
                key += f" {a[1]}"
            secs[key] = time.perf_counter() - t0
            return out
        return wrapped

    va.Report.dump = dump
    for n, fn in originals.items():
        setattr(va, n, timed(n, fn))
    try:
        rc = va.main(argv, device=device)
    finally:
        va.Report.dump = orig_dump
        for n, fn in originals.items():
            setattr(va, n, fn)
    return rc, rows, secs


def phase_validate(device="cuda", size=PHASE12):
    """(a) ``validate_assets`` on every asset kind with ``FUSED_SKINNING =
    "on"``: every row PASS and exit code 0; with broken skinning weights
    exit code 1 and the lbs row FAIL; the skinning kernel against its
    plain version at the SMPL-X forward's arguments, timed."""
    import tempfile

    import torch

    from bodyfitting_torch.models import body_model as bm
    from bodyfitting_torch.ops import kernels as K
    from bodyfitting_torch.tools import validate_assets as va

    on_card = torch.device(device).type == "cuda"
    tmp = tempfile.TemporaryDirectory(prefix="bodyfit_assets_")
    root = tmp.name
    bm.FUSED_SKINNING = "on"
    try:
        t0 = time.perf_counter()
        npz = os.path.join(root, "SMPLX_NEUTRAL.npz")
        broken = os.path.join(root, "SMPLX_BROKEN.npz")
        gmm = os.path.join(root, "gmm_08.pkl")
        write_smplx_asset(npz, size["smplx_faces"])
        write_smplx_asset(broken, size["smplx_faces"], break_weights=True)
        write_gmm_asset(gmm)
        ckpts, ckpt_s = write_checkpoints(root)
        log(f"validate: seeded assets written in "
            f"{time.perf_counter() - t0:.2f} s (checkpoints {ckpt_s:.2f} s: "
            + ", ".join(f"{os.path.basename(p)} "
                        f"{os.path.getsize(p) / 2 ** 20:.1f} MiB"
                        for p in ckpts.values()) + ")")
        argv = ["--model_path", npz, "--model_type", "smplx", "--gmm", gmm]
        for flag, path in ckpts.items():
            argv += [flag, path]
        rec = SkinRecorder()
        sync(device)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        with rec.active():
            rc, rows, secs = run_validate(va, argv, device)
        sync(device)
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
        fails = [r for r in rows if r[0] is False]
        log(f"validate (a): exit code {rc}, {len(rows)} rows, "
            f"{sum(1 for r in rows if r[0])} PASS, {len(fails)} FAIL, in "
            f"{wall:.2f} s on {device}; seconds by asset: "
            + ", ".join(f"{k} {v:.2f}" for k, v in secs.items())
            + f"; launches {counts}")
        assert rc == 0 and not fails, fails
        if on_card:
            assert counts["skin_forward"] == 2 and sum(
                counts.values()) == 2, counts
        rc_b, rows_b, _ = run_validate(
            va, ["--model_path", broken, "--model_type", "smplx"], device)
        lbs = [r for r in rows_b if r[1] == "lbs weight rows sum to 1"]
        log(f"validate (a) broken weights: exit code {rc_b}, lbs row "
            f"{'FAIL' if lbs and lbs[0][0] is False else 'PASS'} "
            f"[{lbs[0][2] if lbs else ''}]")
        assert rc_b == 1 and lbs and lbs[0][0] is False, rows_b
        # the kernel at the SMPL-X forward's arguments
        row = skin_forward_row(*rec.fwd[10475], counts["skin_forward"],
                               "12a validate_assets", on_card)
        return dict(row=row, secs=secs, wall=wall)
    finally:
        bm.FUSED_SKINNING = "auto"
        tmp.cleanup()


def last_call(store):
    """A ``nearest_ops`` replacement that keeps only the last call's
    arguments (an exact fit makes hundreds)."""
    def replace(fn):
        def wrapped(*a, **kw):
            store[:] = [(a, kw)]
            return fn(*a, **kw)
        return wrapped
    return replace


def turned_scan(c2ws, sv):
    """Phase 12 (b)'s second scan: the first turned 90 degrees about the
    vertical (+y) axis and moved 0.1 m along x, its cameras with it (so
    the keypoints stay those of the first)."""
    T = np.eye(4)
    T[:3, :3] = [[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]]
    T[:3, 3] = [0.1, 0.0, 0.0]
    sv1 = (sv.astype(np.float64) @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    return [(T @ c).astype(np.float32) for c in c2ws], sv1


def batch_rounding(model, config, obs, inits, prior):
    """Where frame 0 of a batch of two first rounds otherwise than frame 0
    alone: the forward's vertices and joints, each loss term at the first
    step and the first post-gate step, and the gradient, each compared
    bitwise (max abs difference beside it).  Logs the comparisons and
    returns the names of those that differ."""
    import torch

    from bodyfitting_torch.fitting import smplify
    from bodyfitting_torch.models import body_model as bm

    lm, jm, rows = smplify.loss_models(model, config)
    one, two = obs[0], smplify.concat_frames(obs)
    p1, p2 = inits[0], smplify.concat_frames(inits)
    pairs = {}
    with torch.no_grad():
        for what, m in (("joints model", jm), ("full model", model)):
            if m is None:
                continue
            o1, o2 = bm.forward(m, p1.body), bm.forward(m, p2.body)
            pairs[f"{what} vertices"] = (o1.vertices[0], o2.vertices[0])
            pairs[f"{what} joints"] = (o1.joints[0], o2.joints[0])
    gate = config.num_iters // config.stage_gate_den
    for step in (0, gate + 1):
        res = []
        for o, p in ((one, p1), (two, p2)):
            leaves = [t.detach().clone().requires_grad_(True)
                      for t in p.tensors()]
            loss, terms = smplify.fit_loss(
                lm, config, smplify.FitParams.from_tensors(leaves), o, step,
                prior, joints_model=jm, mask_vertex_rows=rows)
            g = torch.autograd.grad(loss.sum(), leaves, allow_unused=True)
            res.append((terms, g))
        for k in res[0][0]:
            pairs[f"step {step} {k}"] = (res[0][0][k][0].detach(),
                                         res[1][0][k][0].detach())
        names = bm.BODY_PARAM_FIELDS + ("global_transl", "body_scale")
        for name, a, b in zip(names, res[0][1], res[1][1]):
            if a is not None:
                pairs[f"step {step} gradient of {name}"] = (a[0], b[0])
    differ = []
    for k, (a, b) in pairs.items():
        same = torch.equal(a, b)
        if not same:
            differ.append(k)
        log(f"scan batch (b) rounding, frame 0 alone vs in a batch of 2: "
            f"{k}: bitwise equal {same}, max abs diff "
            f"{float((a - b).abs().max()):.3e}")
    return differ


def phase_scan_batch(inp, device="cuda", size=PHASE12):
    """(b) phase 6's scan fit on a batch of two scans through
    ``fit_frames_batched``: both volumes and the SDF fit, then the exact
    route, at phase 6's depths.  Scan 0 against phase 6's one-scan fit;
    scan 1's distances against phase 6's band; the nearest kernel against
    its plain version at the exact fit's last query (scan 1), timed."""
    import torch

    from bodyfitting_torch.fitting import body_fitting as bf
    from bodyfitting_torch.ops import kernels as K
    from bodyfitting_torch.ops.nearest import nearest_points

    on_card = torch.device(device).type == "cuda"
    model, prior, config = inp["model"], inp["prior"], inp["config"]
    c2ws, Ks, kps, sv, sf = inp["problem"]
    c2ws1, sv1 = turned_scan(c2ws, sv)
    R = inp["sdf_resolution"]
    chunks = -(-R ** 3 // 65536)
    sync(device)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    obs = [bf.build_observations(cams, Ks, kps, use_hand_face=False,
                                 scan_verts=verts, scan_faces=sf,
                                 sdf_resolution=R, device=device)
           for cams, verts in ((c2ws, sv), (c2ws1, sv1))]
    inits = [bf.init_params_from_hmr(model, *bf.hmr_init(None, cams[0]))
             for cams in (c2ws, c2ws1)]
    sync(device)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, result, losses = bf.fit_frames_batched(model, config, obs, inits,
                                              prior)
    sync(device)
    fit_s = time.perf_counter() - t0
    launches = K.launch_counts()
    log(f"scan batch (b) SDF route: two {R}^3 volumes in {build_s:.3f} s, "
        f"fit {config.num_iters} + {config.num_iters} iterations of 2 scans "
        f"in {fit_s:.3f} s wall (phase 6, one scan: {inp['fit_s']:.3f} s, "
        f"{fit_s / inp['fit_s']:.2f}x); launches {launches}")
    if on_card:
        assert launches["nearest_d2_idx"] == 2 * chunks, launches
    assert losses.shape == (2, 2 * config.num_iters)
    assert torch.isfinite(losses).all(), "non-finite loss"
    d0 = float((result["vertices"][0] - inp["vertices"]).abs().max()) * 1e3
    dd = float((result["displacement"][0]
                - inp["displacement"]).abs().max()) * 1e3

    def residual_mm(v, o):
        closest, _ = nearest_points(v, o.scan_verts[0], o.scan_faces[0])
        return float((v - closest).norm(dim=1).mean()) * 1e3

    r1 = (residual_mm(result["vertices"][1], obs[1]),
          residual_mm(result["vertices"][1] + result["displacement"][1],
                      obs[1]))
    r6 = inp["residual_mm"]
    batch_rounding(model, config, obs, inits, prior)
    log(f"scan batch (b): scan 0's body vertices sha1 "
        f"{tensor_sha1(result['vertices'][0])}, displacements sha1 "
        f"{tensor_sha1(result['displacement'][0])}")
    log(f"scan batch (b): scan 0 against phase 6's one-scan fit: vertices "
        f"max |diff| {d0:.4f} mm (tol {size['max_scan0_mm']} mm), "
        f"displacements {dd:.4f} mm (not held: nothing holds a vertex in "
        f"place along the surface, ROADMAP 3); scan 1 mean distance to its "
        f"scan "
        f"{r1[0]:.2f} mm body, {r1[1]:.2f} mm with the displacements "
        f"(phase 6: {r6[0]:.2f} / {r6[1]:.2f} mm; band +-"
        f"{size['band'] * 100:.0f} %)")
    assert d0 <= size["max_scan0_mm"], d0
    for a, b in zip(r1, r6):
        assert abs(a - b) <= size["band"] * b, (r1, r6)

    # the exact route at full width and phase 6's cut depth
    ecfg = dataclasses.replace(config, mesh_loss_impl="exact",
                               num_iters=inp["exact_iters"])
    egate = ecfg.num_iters // ecfg.stage_gate_den
    eobs = [dataclasses.replace(o, scan_volume=None) for o in obs]
    last = []
    sync(device)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with nearest_ops(last_call(last)):
        _, eresult, elosses = bf.fit_frames_batched(model, ecfg, eobs,
                                                    inits, prior)
    sync(device)
    exact_s = time.perf_counter() - t0
    elaunches = K.launch_counts()
    expect = 2 * ((ecfg.num_iters - egate - 1) + ecfg.num_iters)
    de = float((eresult["vertices"][0]
                - inp["exact_vertices"]).abs().max()) * 1e3
    log(f"scan batch (b) exact route: {ecfg.num_iters} + {ecfg.num_iters} "
        f"iterations of 2 scans in {exact_s:.3f} s wall (phase 6, one "
        f"scan: {inp['exact_s']:.3f} s); launches {elaunches} (one per "
        f"scan and query; expected {expect}); scan 0 against phase 6's: "
        f"vertices max |diff| {de:.4f} mm")
    assert torch.isfinite(elosses).all()
    if on_card:
        assert elaunches["nearest_d2_idx"] == expect, elaunches
    args, kw = last[0]
    err = check_nearest(args, kw, "two-scan batch, scan 1 in-fit query")
    row = dict(name="nearest_d2_idx", route="cuda",
               source=SOURCES["nearest_d2_idx"],
               replaces=TPU_KERNELS["nearest_d2_idx"],
               launches=launches["nearest_d2_idx"]
               + elaunches["nearest_d2_idx"], max_abs_err=err,
               ms=None, plain_ms=None, bound_ms=None, bound_by=None,
               library_ms=None, phase="12b batch of two scans",
               shape=f"in-fit query Q {args[0].shape[0]} F "
               f"{args[1].shape[0]}, 2 scans a step",
               launches_by_route=dict(sdf=launches["nearest_d2_idx"],
                                      exact=elaunches["nearest_d2_idx"]))
    if on_card:
        pts, tri = args[0], args[1]
        ms = cuda_ms(lambda: K.nearest_d2_idx(*args, **kw), reps=10,
                     warmup=1)
        plain = cuda_ms(lambda: K.nearest_d2_idx_plain(*args, **kw),
                        reps=1, warmup=0)
        d2, _ = K.nearest_d2_idx(*args, **kw)
        pairs = box_survivors(pts, tri, d2, kw["tie_verts"])
        b, by = bound_ms(nbytes(*args, *kw.values()) + pts.shape[0] * 8,
                         NEAREST_OPS_PER_PAIR * pairs)
        log(f"nearest_d2_idx (12b) scan 1 query Q {pts.shape[0]} F "
            f"{tri.shape[0]}: {ms:.3f} ms, plain {plain:.3f} ms, bound "
            f"{b:.5f} ms ({by}; {pairs} pairs that face boxes cannot rule "
            f"out); library: none")
        row.update(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by)
    return dict(row=row, fit_s=fit_s, exact_s=exact_s, scan0_mm=d0,
                scan1_mm=r1, verts=result["vertices"][0], scan=(sv, sf))


@contextlib.contextmanager
def zbuf_recorder(calls):
    """Keep every ``kernels.rasterize_zbuf`` call's arguments; the counted
    wrapper still runs."""
    from bodyfitting_torch.ops import kernels as K

    orig = K.rasterize_zbuf

    def wrapped(face_px, face_z, size):
        calls.append((face_px, face_z, size))
        return orig(face_px, face_z, size)

    K.rasterize_zbuf = wrapped
    try:
        yield
    finally:
        K.rasterize_zbuf = orig


def phase_overlay(ov, device="cuda", size=PHASE12):
    """(c) ``render_fit_overlays`` of phase 9's keypoint fit (frame 0) on
    its 2448 x 2048 views at the JAX cadence (every 12th): each z-buffer
    launch against the plain version on the card, timed; the card against
    the CPU on view 0 at 1/4 size."""
    import torch

    from bodyfitting_torch.ops import kernels as K
    from bodyfitting_torch.utils.overlay import (
        render_fit_overlays,
        render_mesh_overlay,
    )

    on_card = torch.device(device).type == "cuda"
    images, c2ws, Ks = ov["images"], ov["c2ws"], ov["Ks"]
    verts, faces = ov["vertices"], ov["faces"]
    calls = []
    sync(device)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with zbuf_recorder(calls):
        outs = render_fit_overlays(images, {"vertices": verts}, faces, c2ws,
                                   Ks, skip=12, device=device)
    sync(device)
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    H, W = images[0].shape[:2]
    covered = [float((o != images[i]).any(-1).mean()) for i, o in outs]
    log(f"overlay (c): views {[i for i, _ in outs]} at {W}x{H} in "
        f"{wall:.3f} s ({wall / len(outs) * 1e3:.1f} ms a view, the uint8 "
        f"result copied once a view); the mesh over {np.round(covered, 4)} "
        f"of each image; launches {counts}")
    assert [i for i, _ in outs] == [0, 12, 24, 36]
    assert all(0.005 < c < 0.9 for c in covered), covered
    if on_card:
        assert counts["rasterize_zbuf"] == len(outs) and sum(
            counts.values()) == len(outs), counts
    plain_ms, err = [], 0.0
    for (px, fz, S), (i, _) in zip(calls, outs):
        p, e = check_raster("rasterize_zbuf", (px, fz), S,
                            f"overlay view {i}")
        plain_ms.append(p)
        err = max(err, e)
    # the card against the CPU on view 0 at 1/4 size
    small = np.ascontiguousarray(images[0][::4, ::4])
    K4 = np.array(Ks[0], np.float64)
    K4[:2] *= 0.25
    w2c = np.linalg.inv(np.asarray(c2ws[0]))
    got = render_mesh_overlay(small, verts, faces, w2c, K4, device=device)
    t0 = time.perf_counter()
    ref = render_mesh_overlay(small, verts, faces, w2c, K4, device="cpu")
    cpu_s = time.perf_counter() - t0
    d = np.abs(got.astype(int) - ref.astype(int))
    log(f"overlay (c) {device} vs CPU, view 0 at {small.shape[1]}x"
        f"{small.shape[0]}: max {d.max()} level, {(d > 0).mean():.2e} of "
        f"the values differ (tol: 1 level at {size['overlay_share']:.0e}); "
        f"CPU {cpu_s:.2f} s")
    assert d.max() <= 1 and (d > 0).mean() <= size["overlay_share"]
    px, fz, S = calls[0]
    row = dict(name="rasterize_zbuf", route="cuda",
               source=SOURCES["rasterize_zbuf"],
               replaces=TPU_KERNELS["rasterize_zbuf"],
               launches=counts["rasterize_zbuf"], max_abs_err=err,
               ms=None, plain_ms=float(np.mean(plain_ms)), bound_ms=None,
               bound_by=None, library_ms=None, phase="12c overlays",
               shape=f"overlay {S}^2 F {px.shape[0]}")
    if on_card:
        ms = cuda_ms(lambda: K.rasterize_zbuf(px, fz, S), reps=10, warmup=2)
        b = (nbytes(px, fz) + S * S * 8) / HBM_BYTES_PER_S * 1e3
        pairs = box_pairs(px, fz, S)
        log(f"rasterize_zbuf (12c) overlay {S}^2 F {px.shape[0]}: {ms:.4f} "
            f"ms, plain {np.mean(plain_ms):.3f} ms, bound {b:.5f} ms "
            f"(bytes: faces in, depth and index out; {pairs} pixel-face "
            f"pairs in face boxes, "
            f"{RASTER_OPS_PER_PAIR * pairs / F32_FLOPS_PER_S * 1e3:.5f} ms "
            f"of operations); library: none")
        row.update(ms=ms, bound_ms=b, bound_by="bytes")
    return dict(row=row, wall=wall)


def phase_soft(state, device="cuda", size=PHASE12):
    """(d) ``soft_silhouette`` of phase 3's fitted SMPL-X body (frame 0,
    mask view 0) at 512^2, forward and backward on the card, timed, with
    its peak memory; the card against the CPU at 128^2; IoU against the
    hard raster at sigma 1e-6."""
    import torch

    from bodyfitting_torch.fitting import smplify
    from bodyfitting_torch.ops import rasterize as rz

    on_card = torch.device(device).type == "cuda"
    model, obs = state["model"], state["obs"]
    with torch.no_grad():
        verts = smplify.fit_result(model, state["params"],
                                   obs)["vertices"][0].detach()
    faces = model.faces
    w2c, Kc = obs.mask_w2cs[0, 0], obs.mask_Ks[0, 0]
    imsize = size["soft"]
    wts = torch.as_tensor(np.random.default_rng(0).normal(
        size=(imsize, imsize)).astype(np.float32), device=verts.device)

    def run(v, f, w2c, K, S, weights, sigma=1e-4):
        v = v.clone().requires_grad_(True)
        px, fz = rz.project_faces(v, f, w2c, K)
        cov = rz.soft_silhouette(px, S, sigma=sigma, face_z=fz)
        (cov * weights).sum().backward()
        return cov.detach(), v.grad

    base = 0
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    cov, grad = run(verts, faces, w2c, Kc, imsize, wts)
    sync(device)
    wall = time.perf_counter() - t0
    peak = ((torch.cuda.max_memory_allocated() - base) / 2 ** 20
            if on_card else float("nan"))
    fwd_ms = bwd_ms = float("nan")
    if on_card:
        v = verts.clone().requires_grad_(True)

        def fwd():
            px, fz = rz.project_faces(v, faces, w2c, Kc)
            return rz.soft_silhouette(px, imsize, face_z=fz)

        fwd_ms = cuda_ms(fwd, reps=1, warmup=0)     # warm: the run above
        out = fwd()
        bwd_ms = cuda_ms(lambda: torch.autograd.grad(
            out, [v], wts, retain_graph=True), reps=1, warmup=0)
    F = faces.shape[0]
    log(f"soft_silhouette (d) at {imsize}^2, F {F} ({imsize ** 2 * F:.3e} "
        f"pixel-face pairs): forward and backward {wall:.3f} s wall "
        f"(forward {fwd_ms:.1f} ms, backward {bwd_ms:.1f} ms, CUDA events), "
        f"peak memory {peak:.0f} MiB above the inputs; coverage sum "
        f"{float(cov.sum()):.1f}")
    assert torch.isfinite(cov).all() and torch.isfinite(grad).all()
    # IoU against the hard raster at a tiny sigma
    with torch.no_grad():
        px, fz = rz.project_faces(verts, faces, w2c, Kc)
        sharp = rz.soft_silhouette(px, imsize, sigma=1e-6, face_z=fz) > 0.5
        hard = rz.render_silhouette(rz.rasterize(px, fz, imsize)) > 0.5
    iou = float((sharp & hard).sum()) / max(float((sharp | hard).sum()), 1.0)
    log(f"soft_silhouette (d): IoU of the sigma 1e-6 coverage > 0.5 with "
        f"render_silhouette {iou:.5f} (tol >= 0.98); {int(hard.sum())} "
        f"pixels covered")
    assert iou >= 0.98, iou
    # the card against the CPU at 128^2
    S = size["cpu_soft"]
    K4 = Kc.clone()
    K4[:2] *= S / imsize
    w4 = wts[:S, :S].contiguous()
    got = run(verts, faces, w2c, K4, S, w4)
    t0 = time.perf_counter()
    ref = run(verts.cpu(), faces.cpu(), w2c.cpu(), K4.cpu(), S, w4.cpu())
    cpu_s = time.perf_counter() - t0
    cerr = float((got[0].cpu() - ref[0]).abs().max())
    gerr = float((got[1].cpu() - ref[1]).abs().max() / ref[1].abs().max())
    log(f"soft_silhouette (d) {device} vs CPU at {S}^2: coverage max abs "
        f"err {cerr:.3e} (tol {size['soft_cov_tol']:.0e}), vertex gradient "
        f"{gerr:.3e} of its largest entry (tol {size['soft_grad_tol']:.0e}); "
        f"CPU {cpu_s:.2f} s")
    assert cerr <= size["soft_cov_tol"] and gerr <= size["soft_grad_tol"]
    return dict(wall=wall, fwd_ms=fwd_ms, bwd_ms=bwd_ms, peak_mib=peak,
                iou=iou, cov_err=cerr, grad_err=gerr)


def phase_mesh_queries(verts, scan_verts, scan_faces, smpl_faces,
                       device="cuda", size=PHASE12):
    """(e) ``inside_mesh`` of the fitted SMPL's vertices and
    ``intersects_any`` along their normals against the scan, timed; the
    card against the CPU on a seeded 512 of the queries."""
    import torch

    from bodyfitting_torch.ops.mesh_queries import inside_mesh, intersects_any

    dev = verts.device
    faces = torch.as_tensor(scan_faces, device=dev)
    scan = torch.as_tensor(scan_verts, device=dev)
    normals = torch.as_tensor(vertex_normals(
        verts.double().cpu().numpy(), smpl_faces).astype(np.float32),
        device=dev)
    sync(device)
    t0 = time.perf_counter()
    inside = inside_mesh(verts, scan, faces)
    sync(device)
    t1 = time.perf_counter()
    hits = intersects_any(verts, normals, scan, faces)
    sync(device)
    t2 = time.perf_counter()
    Q, F = verts.shape[0], faces.shape[0]
    log(f"mesh queries (e): {Q} queries x {F} faces ({Q * F:.3e} ray "
        f"tests each): inside_mesh {(t1 - t0) * 1e3:.1f} ms "
        f"({float(inside.float().mean()):.3f} inside), intersects_any along "
        f"the normals {(t2 - t1) * 1e3:.1f} ms "
        f"({float(hits.float().mean()):.3f} hit)")
    pick = torch.as_tensor(np.random.default_rng(0).choice(
        Q, size["cpu_queries"], replace=False), device=dev)
    t3 = time.perf_counter()
    cin = inside_mesh(verts[pick].cpu(), scan.cpu(), faces.cpu())
    chit = intersects_any(verts[pick].cpu(), normals[pick].cpu(), scan.cpu(),
                          faces.cpu())
    same = (torch.equal(cin, inside[pick].cpu())
            and torch.equal(chit, hits[pick].cpu()))
    log(f"mesh queries (e): {device} vs CPU on {size['cpu_queries']} "
        f"queries: equal {same} (tol: exact); CPU "
        f"{time.perf_counter() - t3:.2f} s")
    assert same
    return dict(inside_ms=(t1 - t0) * 1e3, hit_ms=(t2 - t1) * 1e3)


def phase_rest(state, scan, app, device="cuda", size=PHASE12):
    """Phase 12: (a) validate_assets, (b) a batch of two scans, (c) the
    overlays, (d) the soft silhouette, (e) the mesh queries.  Returns the
    three kernel rows and each part's results."""
    t0 = time.perf_counter()
    inp = scan["batch_input"]
    a = phase_validate(device, size)
    b = phase_scan_batch(inp, device, size)
    c = phase_overlay(app["overlay"], device, size)
    d = phase_soft(state, device, size)
    e = phase_mesh_queries(b["verts"], *b["scan"],
                           inp["model"].faces.cpu().numpy(), device, size)
    log(f"phase 12: {time.perf_counter() - t0:.1f} s")
    return dict(rows=[a["row"], b["row"], c["row"]], validate=a, batch=b,
                overlay=c, soft=d, queries=e)


# ---------------------------------------------------------------------------
# Phase 13: the multi-device fits over torch.distributed
# ---------------------------------------------------------------------------

# The production-shape sharded problem (parallel/checks.py): the SMPL-X
# synthetic model at 10,475 vertices, 8 frames, 4 keypoint views, 2 masks
# of 128^2 with 256 contour points, the 24^3 volume of a 2,048-vertex
# sphere scan, 60 iterations across the gate; 3 frames of it for the
# temporal fit; the vertex-sharded SMPL-X over 2 ranks.
PHASE13 = dict(n_frames=8, num_iters=60, temporal_frames=3, ranks=2,
               tp_verts=10475, reps=20,
               # the sharded fits against the single-device fit, as the
               # JAX package's hardware check (__graft_entry__.py:264-275)
               pre_gate_rtol=1e-3, last_rtol=0.2, tp_atol=2e-5,
               # the temporal fit over 2x1 against the unsharded one: the
               # same objective, so only rounding (1.2e-7 measured)
               temporal_rtol=1e-4)
PHASE13_KERNELS = KERNEL_NAMES + ("nearest_d2_idx",)


def _frames_of(item, lo, hi):
    """Frames ``lo:hi`` of a dataclass of ``[B, ...]`` tensors."""
    return type(item)(**{
        f.name: (_frames_of(v, lo, hi) if dataclasses.is_dataclass(v)
                 else None if v is None else v[lo:hi])
        for f in dataclasses.fields(item)
        for v in (getattr(item, f.name),)})


def _same_fit(a, b):
    """Two ``(params, result, losses)`` bitwise equal."""
    import torch

    pa, ra, la = a
    pb, rb, lb = b
    return (all(torch.equal(x, y) for x, y in zip(pa.tensors(),
                                                   pb.tensors()))
            and set(ra) == set(rb)
            and all(torch.equal(ra[k], rb[k]) for k in ra)
            and torch.equal(la, lb))


def replay_ms(entries, reps, device):
    """Device ms of one round of the logged collectives ``entries``
    (``comm.LOG``'s), replayed ``reps`` times on fresh tensors, and the
    bytes one round sends from this rank."""
    import torch
    import torch.distributed as dist

    bufs = [(k, torch.ones(shape, dtype=dt, device=device), g)
            for k, shape, dt, g, _ in entries]

    def once():
        for kind, t, g in bufs:
            if kind == "all_reduce":
                dist.all_reduce(t, group=g)
            else:
                parts = [torch.empty_like(t)
                         for _ in range(dist.get_world_size(g))]
                dist.all_gather(parts, t, group=g)

    once()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        once()
    sync(device)
    return ((time.perf_counter() - t0) / reps * 1e3,
            sum(t.numel() * t.element_size() for _, t, _ in bufs))


def sharded_fit(model, config, obs, init, prior, mesh, device, reps):
    """``fit_sequence_sharded`` on ``mesh``, timed on the host clock, its
    collectives logged; a step's collectives and the end gathers are
    replayed ``reps`` times.  Returns ``(fit, record)``."""
    from bodyfitting_torch.ops import comm
    from bodyfitting_torch.parallel import sharding as sh

    comm.LOG = []
    sync(device)
    t0 = time.perf_counter()
    fit = sh.fit_sequence_sharded(model, config, obs, init, prior, mesh=mesh)
    sync(device)
    wall = time.perf_counter() - t0
    entries, comm.LOG = comm.LOG, None
    steps = [e for e in entries if e[0] == "all_reduce"]
    gathers = [e for e in entries if e[0] == "all_gather"]
    per_step = len(steps) // config.num_iters
    assert len(steps) == per_step * config.num_iters, len(steps)
    r = dict(wall=wall, losses=fit[2].cpu(),
             vertices=fit[1]["vertices"].cpu(), calls=len(entries),
             bytes=sum(e[4] for e in entries), step_collectives=per_step,
             step_ms=0.0, step_bytes=0)
    if steps:
        r["step_ms"], r["step_bytes"] = replay_ms(steps[:per_step], reps,
                                                  device)
    r["gather_ms"], r["gather_bytes"] = replay_ms(gathers, reps, device)
    return fit, r


def loss_errors(got, ref, gate):
    """Max relative errors of loss curves ``[B, T]`` (numpy) against the
    single-device fit's: before the stage gate, and at the last step."""
    pre = slice(0, gate + 1)
    return (float(np.max(np.abs(got[:, pre] - ref[:, pre])
                         / np.abs(ref[:, pre]))),
            float(np.max(np.abs(got[:, -1] - ref[:, -1])
                         / np.abs(ref[:, -1]))))


def tp_forward(num_verts, device, time_kernel):
    """The SMPL-X forward vertex-sharded over the world's ranks
    (``tp`` mesh, auto-padded) under ``FUSED_SKINNING = "on"``, against
    the whole model's plain forward (``"auto"``: ``matmul`` + apply) on
    the same parameters; this rank's ``skin_forward`` call is held
    bitwise against its plain version on its inputs, and timed on rank 0
    with ``time_kernel`` (after the other ranks' checks)."""
    import torch
    import torch.distributed as dist

    from bodyfitting_torch.models import body_model as bm
    from bodyfitting_torch.ops import kernels as K
    from bodyfitting_torch.parallel import tensor as tp

    on_card = torch.device(device).type == "cuda"
    full = bm.synthetic_model("smplx", num_verts=num_verts, seed=0,
                              device=device)
    rng = np.random.default_rng(4)
    params = dataclasses.replace(
        bm.BodyParams.zeros(full),
        body_pose=torch.as_tensor(rng.normal(size=(1, 63)) * 0.2,
                                  dtype=torch.float32, device=device),
        betas=torch.as_tensor(rng.normal(size=(1, 10)), dtype=torch.float32,
                              device=device))
    mesh = tp.make_tp_mesh()
    sharded = tp.shard_model_vertices(full, mesh)
    params = tp.replicate_params(params, mesh)
    rec = SkinRecorder()
    bm.FUSED_SKINNING = "on"
    try:
        sync(device)
        K.reset_launch_counts()
        with torch.no_grad(), rec.active():
            got = bm.forward(sharded, params)
        sync(device)
        launches = K.launch_counts()["skin_forward"]
    finally:
        bm.FUSED_SKINNING = "auto"
    with torch.no_grad():
        want = bm.forward(full, params)
    rows = sharded.v_template.shape[0]
    (W, A, vp), = rec.fwd.values()
    rank = dist.get_rank()
    timed = time_kernel and rank == 0
    phase = f"13d rank {rank}: {rows} rows of V {num_verts}"
    if not timed:
        row = skin_forward_row(W, A, vp, launches, phase, on_card, False)
    dist.barrier()
    if timed:
        row = skin_forward_row(W, A, vp, launches, phase, on_card)
    return dict(rows=rows, v_pad=got.vertices.shape[1],
                pad_zero=bool((got.vertices[:, num_verts:] == 0).all()),
                vert_err=float((got.vertices[:, :num_verts]
                                - want.vertices).abs().max()),
                joint_err=float((got.joints - want.joints).abs().max()),
                skin_forward=launches, row=row)


def _rank13(rank, world, store_path, out_dir, size, device):
    """One rank of phase 13 (b)-(d): a gloo world of ``world`` processes
    on card 0 (NCCL refuses two ranks on one card), or on the CPU."""
    import torch
    import torch.distributed as dist

    if device == "cuda":
        torch.cuda.set_device(0)
    else:
        torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        from bodyfitting_torch.fitting import body_fitting as bf
        from bodyfitting_torch.fitting import smplify
        from bodyfitting_torch.parallel import checks
        from bodyfitting_torch.parallel import sharding as sh

        model, config, obs, init, prior = checks.make_production_fit_problem(
            n_frames=size["n_frames"], num_iters=size["num_iters"],
            device=device)
        out = {}
        # (b) the 2x1 and 1x2 meshes
        for name, shape in (("2x1", (world, 1)), ("1x2", (1, world))):
            fit, r = sharded_fit(model, config, obs, init, prior,
                                 sh.make_mesh(*shape), device, size["reps"])
            if name == "2x1":
                assert r["step_collectives"] == 0, r
                n = size["n_frames"] // world
                lo = rank * n
                alone = smplify.fit(model, config,
                                    _frames_of(obs, lo, lo + n),
                                    _frames_of(init, lo, lo + n), prior)
                mine = (smplify.FitParams.from_tensors(
                    [t[lo:lo + n] for t in fit[0].tensors()]),
                    {k: v[lo:lo + n] for k, v in fit[1].items()},
                    fit[2][lo:lo + n])
                r["block_bitwise"] = _same_fit(mine, alone)
            else:
                assert r["step_collectives"] == 2, r
            out[name] = r
        # (c) the temporal fit of 3 frames over 2x1, one padding frame
        T = size["temporal_frames"]
        results, losses = bf.fit_sequence_batched(
            model, config, [_frames_of(obs, i, i + 1) for i in range(T)],
            [_frames_of(init, i, i + 1) for i in range(T)], prior,
            mesh=sh.make_mesh(world, 1))
        out["temporal"] = dict(losses=losses.cpu(),
                               vertices=results["vertices"].cpu())
        # (d) the vertex-sharded SMPL-X under the fused skinning
        out["tp"] = tp_forward(size["tp_verts"], device, time_kernel=True)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def phase_parallel(app=None, size=PHASE13, device="cuda"):
    """Phase 13: (a) a world of one on NCCL, the sharded production fit
    against ``fit_frames_batched``; (b)-(d) a gloo world of two ranks on
    card 0: the 2x1 and 1x2 meshes, the temporal fit, the vertex-sharded
    SMPL-X; (e) phase 9's ``--data_parallel`` runs; (f) the kernels at
    (a)'s last step and the 24^3 volume build.  Returns the kernel rows."""
    import tempfile

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from bodyfitting_torch.fitting import body_fitting as bf
    from bodyfitting_torch.fitting import smplify
    from bodyfitting_torch.ops import kernels as K
    from bodyfitting_torch.parallel import checks
    from bodyfitting_torch.parallel import sharding as sh

    on_card = torch.device(device).type == "cuda"
    t_phase = time.perf_counter()
    # (a) a world of one: the same computation as the single-device fit
    sh.init_world(device)
    assert dist.get_world_size() == 1
    assert dist.get_backend() == ("nccl" if on_card else "gloo")
    builds = []
    sync(device)
    K.reset_launch_counts()
    with nearest_ops(recorder(builds)):
        model, config, obs, init, prior = checks.make_production_fit_problem(
            n_frames=size["n_frames"], num_iters=size["num_iters"],
            device=device)
    t0 = time.perf_counter()
    sharded = sh.fit_sequence_sharded(model, config, obs, init, prior,
                                      mesh=sh.make_mesh())
    sync(device)
    wall_sharded = time.perf_counter() - t0
    launches = K.launch_counts()
    B = size["n_frames"]
    t0 = time.perf_counter()
    single = bf.fit_frames_batched(
        model, config, [_frames_of(obs, i, i + 1) for i in range(B)],
        [_frames_of(init, i, i + 1) for i in range(B)], prior)
    sync(device)
    wall_single = time.perf_counter() - t0
    same = _same_fit(sharded, single)
    losses = single[2].cpu().numpy()
    gate = config.num_iters // config.stage_gate_den
    jump = losses[:, gate + 1] / losses[:, gate]
    log(f"parallel (a): world of one on {dist.get_backend()}: "
        f"fit_sequence_sharded {wall_sharded:.3f} s, fit_frames_batched "
        f"{wall_single:.3f} s wall ({B} frames, {config.num_iters} "
        f"iterations, V {model.num_verts}); bitwise equal: {same}; loss "
        f"jump at the gate x{jump.min():.2f}-x{jump.max():.2f} (bound "
        f"> x1.5); launches {launches}")
    assert same, "the sharded fit in a world of one is not the single fit"
    assert (jump > 1.5).all(), "the stage gate did not fire"
    for name in PHASE13_KERNELS if on_card else ():
        assert launches[name] > 0, f"{name} never launched in phase 13 (a)"

    # (b)-(d) two ranks on card 0 over gloo
    tmp = tempfile.TemporaryDirectory(prefix="bodyfit_ranks_")
    try:
        W = size["ranks"]
        t0 = time.perf_counter()
        mp.spawn(_rank13, args=(W, os.path.join(tmp.name, "store"),
                                tmp.name, size, device), nprocs=W,
                 join=True)
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp.name, f"rank{r}.pt"),
                            weights_only=False) for r in range(W)]
    finally:
        tmp.cleanup()
    for name in ("2x1", "1x2"):
        r = ranks[0][name]
        pre_err, last_err = loss_errors(r["losses"].numpy(), losses, gate)
        vdiff = float((r["vertices"] - single[1]["vertices"].cpu())
                      .abs().max())
        extra = ""
        if name == "2x1":
            extra = (f"; each rank's block bitwise its block fitted alone: "
                     f"{[x[name]['block_bitwise'] for x in ranks]}")
        log(f"parallel (b) {name}: {r['wall']:.3f} s wall (rank 0); vs the "
            f"single-device fit: pre-gate loss max rel err {pre_err:.3e} "
            f"(tol {size['pre_gate_rtol']}), last loss {last_err:.3e} (tol "
            f"{size['last_rtol']}), vertices max abs diff {vdiff:.3e} m; "
            f"{r['calls']} collectives, {r['bytes']} B sent by rank 0; "
            f"collectives a step: {r['step_collectives']} "
            f"({r['step_bytes']} B a rank), {r['step_ms']:.4f} ms replayed; "
            f"the end gathers {r['gather_ms']:.3f} ms, {r['gather_bytes']} B "
            f"a rank{extra}")
        assert pre_err <= size["pre_gate_rtol"], (name, pre_err)
        assert last_err <= size["last_rtol"], (name, last_err)
        if name == "2x1":
            assert all(x[name]["block_bitwise"] for x in ranks)
    T = size["temporal_frames"]
    t_res, t_losses = bf.fit_sequence_batched(
        model, config, [_frames_of(obs, i, i + 1) for i in range(T)],
        [_frames_of(init, i, i + 1) for i in range(T)], prior)
    tr = ranks[0]["temporal"]
    want, want_v = t_losses.cpu().numpy(), t_res["vertices"].cpu()
    loss_err = float(np.max(np.abs(tr["losses"].numpy() - want)
                            / np.abs(want)))
    vert_err = float((tr["vertices"] - want_v).abs().max()
                     / want_v.abs().max())
    log(f"parallel (c): temporal fit of {T} frames over 2x1 (one padding "
        f"frame) vs unsharded: every step's loss max rel err "
        f"{loss_err:.3e}, vertices max abs diff / max |vertex| "
        f"{vert_err:.3e} (tol {size['temporal_rtol']} each); vertices "
        f"{tuple(tr['vertices'].shape)}")
    assert tr["vertices"].shape == want_v.shape
    assert max(loss_err, vert_err) <= size["temporal_rtol"], (loss_err,
                                                               vert_err)
    tpr = ranks[0]["tp"]
    log(f"parallel (d): SMPL-X V {size['tp_verts']} over {W} ranks, "
        f"{tpr['rows']} rows a rank, V_pad {tpr['v_pad']}; vs the whole "
        f"model's plain forward: vertices max abs err "
        f"{tpr['vert_err']:.3e}, joints {tpr['joint_err']:.3e} (tol "
        f"{size['tp_atol']}); pad rows exactly 0: {tpr['pad_zero']}; "
        f"skin_forward launches a rank {[x['tp']['skin_forward'] for x in ranks]}"
        f"; {W} ranks spawned and run in {spawn_s:.1f} s")
    assert tpr["pad_zero"] and max(tpr["vert_err"], tpr["joint_err"]) <= \
        size["tp_atol"]
    assert all(x["tp"]["skin_forward"] == int(on_card) for x in ranks)

    # (e) phase 9's app with --data_parallel
    if app is not None:
        dp = app["data_parallel"]
        log(f"parallel (e): app on {dp['frames']} frames, parameters sha1 "
            f"{dp['single']} single, {dp['dp']} --data_parallel; "
            f"{dp['single_s']:.3f} / {dp['dp_s']:.3f} s wall")
        assert dp["single"] == dp["dp"], dp

    if not on_card:
        dist.destroy_process_group()
        return dict(rows=[], ranks=ranks)
    # (f) the kernels at (a)'s last step and at the volume build
    captured = {}

    def keep_last(kernel, fn):
        def wrapped(*a, **kw):
            key = kernel
            if kernel == "bilinear_cov_grads":
                key = "stay-inside" if kw["with_grads"] else "lookup"
            captured[key] = (tuple(x.detach() if torch.is_tensor(x) else x
                                   for x in a), kw)
            return fn(*a, **kw)
        return wrapped

    with silhouette_ops(keep_last):
        loss_and_grads(smplify.loss_models(model, config), config,
                       sharded[0], obs, prior, config.num_iters - 1)
    rows = [check_bilinear_full(captured, "phase 13"),
            check_contour(captured["contour_match_full"][0],
                          edge_cases=False),
            check_scatter(captured["rows_scatter_add"][0], edge_cases=False)]
    args, kw = builds[0]
    err = check_nearest(args, kw, "phase 13 24^3 volume build")
    pts, tri = args[0], args[1]
    ms = cuda_ms(lambda: K.nearest_d2_idx(*args, **kw), reps=10, warmup=1)
    plain = cuda_ms(lambda: K.nearest_d2_idx_plain(*args, **kw), reps=1,
                    warmup=0)
    d2, _ = K.nearest_d2_idx(*args, **kw)
    pairs = box_survivors(pts, tri, d2, kw["tie_verts"])
    b, by = bound_ms(nbytes(*args, *kw.values()) + pts.shape[0] * 8,
                     NEAREST_OPS_PER_PAIR * pairs)
    log(f"nearest_d2_idx phase 13 build Q {pts.shape[0]} F {tri.shape[0]}: "
        f"{ms:.4f} ms, plain {plain:.3f} ms, bound {b:.5f} ms ({by})")
    rows.append(dict(name="nearest_d2_idx", max_abs_err=err, ms=ms,
                     plain_ms=plain, bound_ms=b, bound_by=by,
                     library_ms=None,
                     shape=f"24^3 build Q {pts.shape[0]} F {tri.shape[0]}"))
    table = [dict(name=r["name"], route="cuda", source=SOURCES[r["name"]],
                  replaces=TPU_KERNELS[r["name"]],
                  launches=launches[r["name"]],
                  **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms",
                                       "shape")}, phase=13)
             for r in rows]
    table.append(dict(tpr["row"], phase=13))
    dist.destroy_process_group()
    log(f"phase 13: {time.perf_counter() - t_phase:.1f} s")
    return dict(rows=table, wall_sharded=wall_sharded,
                wall_single=wall_single, ranks=ranks)


# ---------------------------------------------------------------------------
# Phase 14: the fused per-view mask term (FUSED_MASK_TERM = "fused")
# ---------------------------------------------------------------------------

FUSED_TPU = {
    "mask_terms_forward": "bodyfitting_tpu/losses/silhouette.py:606",
    "mask_terms_backward": "bodyfitting_tpu/losses/silhouette.py:615",
}
FUSED_SOURCE = "bodyfitting_torch/ops/csrc/mask_terms.cu"
# The fused route against the separate one, per view and on dproj: the
# same per-point arithmetic, the per-view sums in other orders (a tree of
# halves against torch.sum's reduction, both O(log n) deep: a few 1e-7),
# and the ICP cotangent rounded in another order (JAX's own tolerance).
FUSED_RTOL = 1e-5
FUSED_GRAD_ATOL = 2e-6          # of the largest dproj entry
# f32 operations a projected vertex (scale, origin, the sampler with its
# derivatives, the closed-form coverage, the three differences) and a
# contour pixel after its match (distance, lookup, coefficient, terms);
# the match itself is counted as check_contour counts it, 7 a pair.
VERTEX_OPS, PIXEL_OPS, PAIR_OPS = 46, 25, 7


@contextlib.contextmanager
def mask_route(route):
    """``FUSED_MASK_TERM = route`` for the block."""
    from bodyfitting_torch.losses import silhouette as sil

    old = sil.FUSED_MASK_TERM
    sil.FUSED_MASK_TERM = route
    try:
        yield
    finally:
        sil.FUSED_MASK_TERM = old


def route_terms(route, args, imsize, epsilon, full_hw):
    """``(icp [BV], binary [BV], dproj [BV, M, 2])`` at ``proj = args[0]``
    through one route: "fused" (``MaskViewTerms``) or the separate ops;
    dproj is the gradient of ``sum(icp) + epsilon sum(binary)``."""
    import torch

    from bodyfitting_torch.losses import silhouette as sil

    proj = args[0].detach().clone().requires_grad_(True)
    if route == "fused":
        icp, binary = sil.MaskViewTerms.apply(proj, *args[1:], imsize,
                                              epsilon, full_hw)
    else:
        icp, binary = sil.separate_view_terms(
            proj, *args[1:], imsize=imsize, epsilon=epsilon, full_hw=full_hw)
    (dproj,) = torch.autograd.grad(icp.sum() + binary.sum() * epsilon, proj)
    return icp.detach(), binary.detach(), dproj


def kernels_a_step(prof, names):
    """``{name: (launches, device us)}`` a unit for the kernels whose
    names hold each of ``names``, from :func:`traced`'s result."""
    return {n: tuple(sum(v[j] for k, v in prof["by_name"].items() if n in k)
                     for j in (0, 1)) for n in names}


def phase_fused_mask(state, device="cuda", n_steps=20, smi=""):
    """Phase 14: the fused route on phase 3's fit (see the docstring)."""
    import torch

    from bodyfitting_torch.fitting import smplify
    from bodyfitting_torch.losses import silhouette as sil
    from bodyfitting_torch.ops import kernels as K
    from bodyfitting_torch.ops.kernels import mask_terms as MT

    on_card = torch.device(device).type == "cuda"
    assert sil.FUSED_MASK_TERM == "auto", sil.FUSED_MASK_TERM
    cfg = state["config"]

    # (a) the fit's loss and gradient at its final state by both routes,
    # the fused kernels' arguments recorded
    calls = {n: [] for n in FUSED_NAMES}

    def record(name, fn):
        def wrapped(*a, **kw):
            calls[name].append((a, kw))
            return fn(*a, **kw)
        return wrapped

    args = (state["models"], cfg, state["params"], state["obs"],
            state["prior"], cfg.num_iters - 1)
    with mask_route("fused"), silhouette_ops(record, FUSED_NAMES):
        lf, gf = loss_and_grads(*args)
    with mask_route("separate"):
        ls, gs = loss_and_grads(*args)
    loss_err = float(((lf - ls).abs() / ls.abs()).max())
    top = max(float(g.abs().max()) for g in gs)
    grad_err = max(float((a - b).abs().max()) for a, b in zip(gf, gs)) / top
    log(f"fused (a): fit loss at the final state, fused vs separate route: "
        f"max rel err {loss_err:.3e} (tol 1e-5); gradient max err "
        f"{grad_err:.3e} of the largest entry (tol 1e-5)")
    assert loss_err <= 1e-5 and grad_err <= 1e-5
    ((fargs, _),) = calls["mask_terms_forward"]
    ((bargs, _),) = calls["mask_terms_backward"]
    fargs = (fargs[0].detach(), *fargs[1:])
    proj, contour, cvalid, crop, origin, vvalid, imsize, eps, full_hw = fargs
    BV, M, _ = proj.shape
    P = contour.shape[1]

    # (b) both kernels bitwise their plain versions, and a second launch
    got = K.mask_terms_forward(*fargs)
    again = K.mask_terms_forward(*fargs)
    ref = K.mask_terms_forward_plain(*fargs)
    dk = K.mask_terms_backward(*bargs)
    dk2 = K.mask_terms_backward(*bargs)
    dp = K.mask_terms_backward_plain(*bargs)
    sync(device)
    same = {n: torch.equal(a, b)
            for n, a, b in zip(("sums", "idx", "pix", "vert"), got, ref)}
    same["dproj"] = torch.equal(dk, dp)
    repeat = (all(torch.equal(a, b) for a, b in zip(got, again))
              and torch.equal(dk, dk2))
    f_err = max(float((a.double() - b.double()).abs().max())
                for a, b in zip(got, ref))
    b_err = float((dk - dp).abs().max())
    log(f"fused (b): BV {BV} P {P} M {M}, crops {tuple(crop.shape)} "
        f"{crop.dtype}; kernels bitwise equal to plain: {same}; two "
        f"launches bitwise equal: {repeat} (tol: exact)")
    assert all(same.values()) and repeat, same

    # (c) the routes at the captured projection, value and dproj
    ti, tb, td = route_terms("fused", fargs[:6], imsize, eps, full_hw)
    si, sb, sd = route_terms("separate", fargs[:6], imsize, eps, full_hw)

    def rel(a, b):
        return float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())

    icp_err, bin_err = rel(ti, si), rel(tb, sb)
    d_err = float((td - sd).abs().max()) / float(sd.abs().max())
    log(f"fused (c): fused vs separate per view: icp max rel err "
        f"{icp_err:.3e}, binary {bin_err:.3e} (tol {FUSED_RTOL:g}); dproj "
        f"max err {d_err:.3e} of the largest entry (tol "
        f"{FUSED_GRAD_ATOL:g})")
    assert max(icp_err, bin_err) <= FUSED_RTOL and d_err <= FUSED_GRAD_ATOL

    # (d) 20 post-gate steps of phase 3's fit a route, in turns, the
    # counters zeroed around the first fused run (the fused path's run)
    fresh = smplify.FitParams.from_tensors(
        [p.clone() for p in state["init"].tensors()])
    step_fn = smplify.make_step_fn(state["model"], cfg, state["obs"],
                                   state["prior"],
                                   smplify.make_optimizer(cfg, fresh))
    i = cfg.num_iters // cfg.stage_gate_den + 1
    for route in ("separate", "fused"):
        with mask_route(route):
            steps_ms(step_fn, range(i, i + 3), device)
        i += 3
    step = {"separate": [], "fused": []}
    launches = None
    for route in ("separate", "fused", "fused", "separate"):
        with mask_route(route):
            if route == "fused" and launches is None:
                K.reset_launch_counts()
                step[route].append(steps_ms(step_fn, range(i, i + n_steps),
                                            device))
                launches = K.launch_counts()
            else:
                step[route].append(steps_ms(step_fn, range(i, i + n_steps),
                                            device))
        i += n_steps
    log(f"fused (d): ms a post-gate step, {n_steps} steps a run, host clock "
        f"(separate, fused, fused, separate): "
        + ", ".join(f"{r} {t:.3f}" for r, t in (
            ("separate", step["separate"][0]), ("fused", step["fused"][0]),
            ("fused", step["fused"][1]), ("separate", step["separate"][1])))
        + f"; launches in the fused run {launches}; {smi}")
    if on_card:
        assert launches["mask_terms_forward"] == 2 * n_steps, launches
        assert launches["mask_terms_backward"] == n_steps, launches
        for name in KERNEL_NAMES:
            assert launches[name] == 0, launches
    rows = dict(
        mask_terms_forward=dict(max_abs_err=f_err, shape=f"BV {BV} P {P} "
                                f"M {M}", launch=MT.forward_geometry(BV, P, M)
                                if on_card else None),
        mask_terms_backward=dict(max_abs_err=b_err, shape=f"BV {BV} P {P} "
                                 f"M {M}", launch=MT.backward_geometry(BV, P, M)
                                 if on_card else None))
    if not on_card:
        return [dict(name=n, launches=launches[n], **r)
                for n, r in rows.items()]
    log(f"fused launch geometry: forward {rows['mask_terms_forward']['launch']}"
        f", backward {rows['mask_terms_backward']['launch']}")

    # (e) kernels a post-gate step under each route, traced
    per_step = {}
    for route in ("separate", "fused"):
        with mask_route(route):
            prof = profile_steps(step_fn, range(i, i + 10),
                                 f"post-gate steps, FUSED_MASK_TERM "
                                 f"\"{route}\"")
        i += 10
        per_step[route] = dict(calls=prof["calls"], busy_ms=prof["busy_ms"],
                               wall_ms=prof["wall_ms"],
                               **kernels_a_step(prof, (
                                   "mask_terms_points_kernel",
                                   "mask_terms_sums_kernel",
                                   "mask_terms_backward_kernel",
                                   "bilinear_cov_grads_kernel",
                                   "contour_match_full_kernel",
                                   "rows_scatter_add_kernel")))
    log(f"fused (e): kernels and copies a post-gate step: separate "
        f"{per_step['separate']['calls']:.0f}, fused "
        f"{per_step['fused']['calls']:.0f}; by kernel {per_step}")
    f = per_step["fused"]
    assert (f["mask_terms_points_kernel"][0] == 1
            and f["mask_terms_sums_kernel"][0] == 1
            and f["mask_terms_backward_kernel"][0] == 1), f
    assert f["bilinear_cov_grads_kernel"][0] == 0, f
    assert per_step["separate"]["mask_terms_points_kernel"][0] == 0

    # (f) each route a call, forward and backward: device busy time and
    # kernels (torch.profiler; CUDA events would time the host, which
    # cannot keep the separate route's many small kernels queued) and the
    # host clock; the kernels alone beside their plain versions
    route_us = {}
    for route in ("separate", "fused", "fused", "separate"):
        def fn(r=route):
            return route_terms(r, fargs[:6], imsize, eps, full_hw)
        fn()
        tr = traced(lambda: [fn() for _ in range(20)], 20)
        route_us.setdefault(route, []).append(dict(
            device_us=tr["busy_ms"] * 1e3, kernels=tr["calls"],
            host_us=host_ms(fn) * 1e3))
    log("fused (f): a route's forward and backward a call at BV "
        f"{BV}, P {P}, M {M} (separate, fused, fused, separate): " + "; ".join(
            f"{r} {d['device_us']:.1f} us device, {d['kernels']:.0f} kernels "
            f"and copies, {d['host_us']:.1f} us host" for r, d in (
                ("separate", route_us["separate"][0]),
                ("fused", route_us["fused"][0]),
                ("fused", route_us["fused"][1]),
                ("separate", route_us["separate"][1]))))
    kernel_us = kernels_a_step(traced(
        lambda: [route_terms("fused", fargs[:6], imsize, eps, full_hw)
                 for _ in range(20)], 20),
        ("mask_terms_points_kernel", "mask_terms_sums_kernel",
         "mask_terms_backward_kernel"))
    log(f"fused (f): each kernel's device us a call (launches, us): "
        f"{kernel_us}")
    fwd = cuda_ms(lambda: K.mask_terms_forward(*fargs))
    fwd_plain = cuda_ms(lambda: K.mask_terms_forward_plain(*fargs), reps=10)
    fwd_host = host_ms(lambda: K.mask_terms_forward(*fargs))
    bwd = cuda_ms(lambda: K.mask_terms_backward(*bargs))
    bwd_plain = cuda_ms(lambda: K.mask_terms_backward_plain(*bargs), reps=10)
    bwd_host = host_ms(lambda: K.mask_terms_backward(*bargs))
    idx, pix, vert = got[1:]
    live = int((pix[:, 1] != 0).sum())
    fb, fby = bound_ms(
        nbytes(proj, contour, cvalid, crop, origin, vvalid, *got),
        PAIR_OPS * BV * P * M + VERTEX_OPS * BV * M + PIXEL_OPS * BV * P
        + BV * (P + M))
    bb, bby = bound_ms(
        nbytes(idx, pix[:, 1:], vert[:, 1:], bargs[3], bargs[4], vvalid, dk),
        5 * live + 6 * BV * M)
    log(f"mask_terms_forward: {fwd:.4f} ms (two launches), plain "
        f"{fwd_plain:.4f} ms, bound {fb:.4f} ms ({fby}); {fwd_host:.4f} ms "
        f"per call on the host clock")
    log(f"mask_terms_backward: {bwd:.4f} ms, plain {bwd_plain:.4f} ms, bound "
        f"{bb:.4f} ms ({bby}); {bwd_host:.4f} ms per call on the host clock; "
        f"{live} of {BV * P} contour pixels matched")
    times = dict(mask_terms_forward=(fwd, fwd_plain, fb, fby),
                 mask_terms_backward=(bwd, bwd_plain, bb, bby))
    table = []
    for name, r in rows.items():
        ms, plain, b, by = times[name]
        table.append(dict(
            name=name, route="cuda", source=FUSED_SOURCE,
            replaces=FUSED_TPU[name], launches=launches[name],
            max_abs_err=r["max_abs_err"], ms=ms, plain_ms=plain, bound_ms=b,
            bound_by=by, library_ms=None, shape=r["shape"], phase=14,
            step_ms=step, kernels_a_step={k: v["calls"]
                                          for k, v in per_step.items()},
            route_us=route_us, kernel_us=kernel_us))
    return table


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace 20 post-gate steps of the mask fit, and 20 "
                    "post-gate and 20 displacement steps of the SDF scan "
                    "fit, with torch.profiler")
    ap.add_argument("--save-volume", metavar="NPZ",
                    help="write the scan problem, its 96^3 volume and the "
                    "SDF fit's result here (for tests/scan_fit_vs_jax.py)")
    ap.add_argument("--save-rp", metavar="NPZ",
                    help="write phase 10's scan and ground-truth joints here "
                    "(for tests/rp_mask_fit_vs_jax.py)")
    cli = ap.parse_args()

    t_start = time.perf_counter()
    smi = phase_device()
    sys.path.insert(0, REPO)
    import torch

    phase_build()
    state = phase_main_path(cli.profile)
    phase_checks(state)
    table = phase_kernels(state)
    table.extend(phase_fused_mask(state, smi=smi))
    scan = phase_scan(smi=smi, profile=cli.profile,
                      save_volume=cli.save_volume)
    table.append(nearest_row(scan))
    texture = phase_texture(scan, smi=smi)
    table.extend(texture["table"])
    app = phase_app(smi=smi)
    table.extend(skin_rows(app))
    rp = phase_rp_app(smi=smi, save_rp=cli.save_rp)
    phase_openpose(state, smi=smi)
    rest = phase_rest(state, scan, app)
    table.extend(rest["rows"])
    for row in table:
        row["launches_rp_app"] = {k: r["counts"][row["name"]]
                                  for k, r in rp["runs"].items()}
        if row["name"] in rp["silhouette"]:
            row["rp_app_c"] = {k: v for k, v in rp["silhouette"][
                row["name"]].items() if k != "name"}
    table.extend(phase_parallel(app)["rows"])
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
