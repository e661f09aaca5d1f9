#!/usr/bin/env python3
"""Start the PyTorch port (``bodyfitting_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments, on a machine with one
CUDA card, ``nvcc`` (``/usr/local/cuda``) and scipy:

    python3 chip_smoke.py              # add --profile for a kernel trace

``--save-volume NPZ`` also writes the scan problem, its distance volume
and the SDF fit's result, for ``python -m tests.scan_fit_vs_jax NPZ``
(the same fit by the JAX package on the CPU).

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
   --tasks smplify``, 120 iterations.  The counters are zeroed around each
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

The line before the last is the kernel table as one JSON object; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

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


@contextlib.contextmanager
def silhouette_ops(replace):
    """Temporarily replace the silhouette loss's kernel entry points:
    ``replace(name, fn)`` returns the function to call instead."""
    from bodyfitting_torch.losses import silhouette as sil

    orig = {n: getattr(sil, n) for n in KERNEL_NAMES}
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
    # plain f32 everywhere: no TF32 in matmuls or convolutions
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
    return dict(model=model, prior=prior, obs=obs, params=params,
                config=config, models=models, launches=launches,
                wall=wall, pre_ms=pre, post_ms=post, digest=digest)


def profile_steps(step_fn, steps, what="post-gate steps"):
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for i in steps:
            step_fn(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    from torch.autograd import DeviceType

    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in events)
    calls = sum(e.count for e in events) / len(steps)
    log(f"profile: {len(steps)} {what}, {wall * 1e3:.1f} ms wall, "
        f"device busy {dev_us / 1e3:.1f} ms "
        f"({100 * dev_us / 1e3 / (wall * 1e3):.1f} %), {calls:.0f} device "
        f"kernels and copies a step")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"  {e.self_device_time_total / len(steps):9.1f} us/step "
            f"{e.count // len(steps):5d} calls/step  {e.key[:90]}")


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


def check_bilinear_full(calls):
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
        log(f"bilinear_cov_grads rp app (c) {what} (BV {BV}, {H}x{W} f32 "
            f"full masks, N {N}, {kw}): bitwise equal to plain: {same} "
            f"(tol: exact)")
        assert same, f"bilinear_cov_grads differs (rp app (c) {what})"
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
        log(f"bilinear_cov_grads rp app (c) {what} launch {geo}: {ms:.5f} "
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
        model, config, obs, body_vertices)

    def disp_step(_):
        import torch

        disp.requires_grad_(True)
        (g,) = torch.autograd.grad(disp_loss(disp), [disp])
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
        model, ecfg, eobs, eresult["vertices"])
    dstate = eresult["displacement"]
    qcalls = []

    def disp_loss_grad():
        d = dstate.detach().clone().requires_grad_(True)
        loss = disp_loss(d)
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


def write_genebody_subject(root, model, size, seed=0):
    """A synthetic GeneBody subject under ``root/genebody/smoke``, written
    with the port's own writers: ``annots.npy`` with 48 ring cameras,
    ``mask/%02d/%04d.png`` at the capture resolution for every view and
    frame, ``image/00`` (the frame listing) and ``image/25`` (the HMR
    keyframe), and the OpenPose keypoints (body, hands, face) of seeded
    SMPL-X bodies projected into each view's 512^2 crop, plus 1 px of
    noise: these stand in for the openpose.bin run.  The bodies face the
    keyframe camera as HMR's mean pose does, turned by a seeded 0.15 rad.
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
        m = splat_mask(project(verts[f], c2ws[v], Ks[v]) / s, W // s, 2,
                       height=H // s)
        return np.repeat(np.repeat((m > 0).astype(np.uint8) * 255, s, 0), s, 1)

    for v in range(n_views):
        os.makedirs(os.path.join(sub, "mask", "%02d" % v))
    for v in (0, key):
        os.makedirs(os.path.join(sub, "image", "%02d" % v))

    def write_view(job):
        f, v = job
        m = mask_of(f, v)
        t0 = time.perf_counter()
        write_png(os.path.join(sub, "mask", "%02d" % v, "%04d.png" % f), m,
                  level=1)
        dt = time.perf_counter() - t0
        if v in (0, key):
            img = np.repeat(m[..., None] // 2, 3, 2)       # grey person
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
    return dict(sub=sub, c2ws=c2ws, crop_K=crop_K, clean=clean, kps=kps,
                write_s=write_s, encode_ms=png_ms, decode_ms=decode_ms)


def write_keypoint_jsons(out_dir, kps, frames):
    for (f, v), person in kps.items():
        if f not in frames:
            continue
        d = os.path.join(out_dir, SUBJECT, "%06d" % f, "openpose")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "%02d_keypoints.json" % v), "w") as fh:
            json.dump({"people": [{k: np.asarray(b).reshape(-1).tolist()
                                   for k, b in person.items()}]}, fh)


def subject_of_first_frames(root, subject_dir, n):
    """A second subject whose frame listing holds the first ``n`` frames;
    masks, keyframe images and cameras are the first subject's (links)."""
    dst = os.path.join(root, "genebody8", SUBJECT)
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
                              params_sha1=digest,
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
        return dict(runs=runs, rows=rows, err=err, onoff=onoff,
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


def write_rp_scans(root, model, size, seed=0):
    """A RenderPeople directory with one scan: the scan phase's problem for
    ``model`` written as ``scans/<subject>/<subject>.obj`` (``v``, ``vt``,
    ``f v/vt``) with an MTL whose ``map_Kd`` names the committed 2048^2
    JPEG, copied to ``tex/``.  Returns the scan as the app loads it, the
    ground truth's joints, and the OBJ parse and JPEG decode times."""
    import shutil

    from bodyfitting_torch.io.images import imread_checked
    from bodyfitting_torch.io.obj import load_obj, save_obj_uv

    *_, sv, sf, joints = make_scan_problem(
        model, size["viewnum"], size["load_size"], size["subdivisions"],
        seed=seed, with_joints=True)
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
                parse_s=parse_s, decode_s=decode_s,
                obj_mib=os.path.getsize(obj) / 2 ** 20)


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


def phase_rp_app(size=RP_APP_PATH, device="cuda", smi=""):
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
            ("c", out_c, ["--use_mask", "--tasks", "smplify", "--num_iters",
                          str(size["mask_iters"])],
             dict(nearest_d2_idx=n_vol, rasterize_zbuf=size["viewnum"],
                  bilinear_cov_grads=2 * post_gate,
                  contour_match_full=post_gate, rows_scatter_add=post_gate)),
        )
        clean = {}
        runs = {}
        captured = {}      # run (c)'s last silhouette kernel calls

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

        # run (a)'s fit against the ground truth and the scan
        pa = np.load(os.path.join(out_a, RP_SUBJECT, "smplify",
                                  "smpl_parameter.npy"),
                     allow_pickle=True).item()
        dev = torch.device(device)
        sv_t = torch.as_tensor(scan.verts, device=dev)
        sf_t = torch.as_tensor(scan.faces.astype(np.int64), device=dev)
        smpld = pa["vertices"] + pa["displacement"]
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace 20 post-gate steps of the mask fit, and 20 "
                    "post-gate and 20 displacement steps of the SDF scan "
                    "fit, with torch.profiler")
    ap.add_argument("--save-volume", metavar="NPZ",
                    help="write the scan problem, its 96^3 volume and the "
                    "SDF fit's result here (for tests/scan_fit_vs_jax.py)")
    cli = ap.parse_args()

    t_start = time.perf_counter()
    smi = phase_device()
    sys.path.insert(0, REPO)
    import torch

    phase_build()
    state = phase_main_path(cli.profile)
    phase_checks(state)
    table = phase_kernels(state)
    scan = phase_scan(smi=smi, profile=cli.profile,
                      save_volume=cli.save_volume)
    table.append(nearest_row(scan))
    texture = phase_texture(scan, smi=smi)
    table.extend(texture["table"])
    app = phase_app(smi=smi)
    table.extend(skin_rows(app))
    rp = phase_rp_app(smi=smi)
    for row in table:
        row["launches_rp_app"] = {k: r["counts"][row["name"]]
                                  for k, r in rp["runs"].items()}
        if row["name"] in rp["silhouette"]:
            row["rp_app_c"] = {k: v for k, v in rp["silhouette"][
                row["name"]].items() if k != "name"}
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
