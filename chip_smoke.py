#!/usr/bin/env python3
"""Start the PyTorch port (``bodyfitting_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments, on a machine with one
CUDA card, ``nvcc`` (``/usr/local/cuda``) and scipy:

    python3 chip_smoke.py              # add --profile for a kernel trace

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
   counters are zeroed just before the fit and read just after it.
4. checks: the loss is finite, the mask term is live after the gate and
   the masked stage descends; at the fit's final state
   the loss and its gradient with the kernels equal those with the plain
   PyTorch versions on the card; a small fit on the card equals the same
   fit on the CPU (plain versions).
5. kernels: each kernel against its plain version on the inputs the main
   path gave it at its final state, and timed beside the plain version
   and a PyTorch call that computes (nearly) the same function.

The line before the last is the kernel table as one JSON object; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
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

TPU_KERNELS = {
    "bilinear_cov_grads": "bodyfitting_tpu/ops/pallas_kernels.py:1242",
    "contour_match_full": "bodyfitting_tpu/ops/pallas_kernels.py:1620",
    "rows_scatter_add": "bodyfitting_tpu/ops/pallas_kernels.py:1738",
}
SOURCES = {
    "bilinear_cov_grads": "bodyfitting_torch/ops/csrc/bilinear.cu",
    "contour_match_full": "bodyfitting_torch/ops/csrc/contour_match.cu",
    "rows_scatter_add": "bodyfitting_torch/ops/csrc/rows_scatter.cu",
}


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# The problem: seeded ground-truth bodies seen by a ring of cameras
# ---------------------------------------------------------------------------


def ring_cameras(n, imsize, focal, dist):
    """``n`` cameras on a horizontal ring, all looking at the origin."""
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
        Ks.append(np.array([[focal, 0, imsize / 2], [0, focal, imsize / 2],
                            [0, 0, 1]], np.float32))
    return c2ws, Ks


def project(pts, c2w, K):
    w2c = np.linalg.inv(c2w)
    uv = (pts @ w2c[:3, :3].T + w2c[:3, 3]) @ K.T
    return uv[:, :2] / uv[:, 2:3]


def splat_mask(pts_uv, imsize, dilate):
    """A filled silhouette from projected vertices (no OpenCV)."""
    from scipy import ndimage

    uv = np.round(pts_uv).astype(np.int64)
    ok = (uv >= 0).all(1) & (uv < imsize).all(1)
    m = np.zeros((imsize, imsize), bool)
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
    loss, _ = smplify.fit_loss(
        loss_model, config, smplify.FitParams.from_tensors(leaves), obs,
        step, prior, joints_model=joints_model, mask_vertex_rows=rows)
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
        regs = [ln.strip() for ln in out.splitlines() if "Used" in ln]
        log(f"  {name}: " + " | ".join(regs))


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


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

    def steps_ms(steps):
        sync(device)
        t = time.perf_counter()
        for i in steps:
            step_fn(i)
        sync(device)
        return (time.perf_counter() - t) / len(steps) * 1e3

    n = max(min(40, gate - 3), 1)
    steps_ms(range(0, 3))
    pre = steps_ms(range(3, 3 + n))
    steps_ms(range(gate + 1, gate + 4))
    post = steps_ms(range(gate + 4, gate + 4 + n))
    log(f"step time: {pre:.3f} ms/iteration before the gate, {post:.3f} "
        f"ms/iteration after it ({n} steps each, host clock)")
    if profile:
        profile_steps(step_fn, range(gate + 4 + n, gate + 24 + n))
    return dict(model=model, prior=prior, obs=obs, params=params,
                config=config, models=models, launches=launches,
                wall=wall, pre_ms=pre, post_ms=post)


def profile_steps(step_fn, steps):
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
    log(f"profile: {len(steps)} post-gate steps, {wall * 1e3:.1f} ms wall, "
        f"device busy {dev_us / 1e3:.1f} ms "
        f"({100 * dev_us / 1e3 / (wall * 1e3):.1f} %)")
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
    import torch
    import torch.nn.functional as F

    from bodyfitting_torch.ops import kernels as K

    calls = capture_kernel_inputs(state)
    rows = []

    # --- bilinear_cov_grads: the stay-inside sample (with_grads) and the
    # matched-pixel lookup (value only); the full-mask mode (with_cov) on
    # the stay-inside positions
    (look_args, look_kw), (stay_args, stay_kw) = calls["bilinear_cov_grads"]
    assert not look_kw["with_grads"] and stay_kw["with_grads"]
    img, xy = stay_args
    BV, Hc, Wc = img.shape
    N = xy.shape[1]
    err = 0.0
    for a, kw in ((stay_args, stay_kw), (look_args, look_kw),
                  (stay_args, dict(with_grads=True, with_cov=True))):
        got = K.bilinear_cov_grads(*a, **kw)
        ref = K.bilinear_cov_grads_plain(*a, **kw)
        torch.cuda.synchronize()
        e = float((got - ref).abs().max())
        log(f"bilinear_cov_grads {tuple(a[0].shape)} x {tuple(a[1].shape)} "
            f"{kw}: max abs err {e:.3e} (tol 1e-6)")
        assert e <= 1e-6
        err = max(err, e)
    ms = cuda_ms(lambda: K.bilinear_cov_grads(img, xy, **stay_kw))
    plain = cuda_ms(lambda: K.bilinear_cov_grads_plain(img, xy, **stay_kw),
                    reps=10)
    scale = torch.tensor([2.0 / (Wc - 1), 2.0 / (Hc - 1)], device=xy.device)
    grid = (xy * scale - 1.0)[:, None]                      # [BV, 1, N, 2]
    lib = cuda_ms(lambda: F.grid_sample(img[:, None], grid, mode="bilinear",
                                        padding_mode="zeros",
                                        align_corners=True))
    look_ms = cuda_ms(lambda: K.bilinear_cov_grads(*look_args, **look_kw))
    host = host_ms(lambda: K.bilinear_cov_grads(img, xy, **stay_kw))
    near, taps = touched_taps(img, xy)
    # bytes: xy, the [BV, 6, N] output, and each distinct pixel that a
    # near point's 4 taps touch, read once.  Operations per near point:
    # 2 floors, 6 weight ops, 9 for the sample, 16 for the two
    # derivatives and their step factors
    b, by = bound_ms(4 * taps + nbytes(xy) + BV * 6 * N * 4, 33 * near)
    log(f"bilinear_cov_grads stay-inside: {ms:.4f} ms, plain {plain:.4f} ms, "
        f"grid_sample (sample only) {lib:.4f} ms, bound {b:.4f} ms "
        f"({by}); lookup call {look_ms:.4f} ms; {near} of {BV * N} points "
        f"near the crop, {taps} distinct pixels touched of "
        f"{img.numel()}; {host:.4f} ms per call on the host clock")
    rows.append(dict(name="bilinear_cov_grads", max_abs_err=err, ms=ms,
                     plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib))

    # --- contour_match_full (+ contour_min_idx on the same kernel)
    ((cargs, _),) = calls["contour_match_full"]
    contour, proj, valid, inside = cargs
    got = K.contour_match_full(*cargs)
    ref = K.contour_match_full_plain(*cargs)
    torch.cuda.synchronize()
    assert torch.equal(got[1], ref[1]), "contour_match_full idx differ"
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(got, ref))
    d2m, idxm = K.contour_min_idx(contour, proj, valid)
    d2p, idxp, _, _ = K.contour_match_full_plain(
        contour, proj, valid, torch.zeros_like(valid))
    assert torch.equal(idxm, idxp), "contour_min_idx idx differ"
    err = max(err, float((d2m - d2p).abs().max()))
    _, P, _ = contour.shape
    M = proj.shape[1]
    log(f"contour_match_full BV {BV} P {P} M {M}: idx equal, payload max "
        f"abs err {err:.3e} (tol 0: same rounding); contour_min_idx idx "
        f"equal")
    assert err == 0.0
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
    rows.append(dict(name="contour_match_full", max_abs_err=err, ms=ms,
                     plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib))

    # --- rows_scatter_add: the ICP backward's cotangent onto the matches
    ((sargs, _),) = calls["rows_scatter_add"]
    idx, g, Mc = sargs
    r1 = K.rows_scatter_add(idx, g, Mc)
    r2 = K.rows_scatter_add(idx, g, Mc)
    ref = K.rows_scatter_add_plain(idx, g, Mc)
    torch.cuda.synchronize()
    assert torch.equal(r1, r2), "rows_scatter_add is not bitwise repeatable"
    err = float((r1 - ref).abs().max())
    # two summation orders of n terms differ by at most 2 n eps sum|g|
    n_terms = K.rows_scatter_add_plain(idx, torch.ones_like(g), Mc)
    bound = 2 * n_terms * 2.0 ** -23 * K.rows_scatter_add_plain(
        idx, g.abs(), Mc)
    ok = bool(((r1 - ref).abs() <= bound).all())
    log(f"rows_scatter_add BV {BV} P {idx.shape[1]} C {g.shape[2]} M {Mc}: "
        f"two launches bitwise equal; max abs err vs plain {err:.3e}, "
        f"within 2 n eps sum|g| everywhere: {ok} (the plain scatter_add_ "
        f"sums in another order)")
    assert ok
    ms = cuda_ms(lambda: K.rows_scatter_add(idx, g, Mc))
    plain = cuda_ms(lambda: K.rows_scatter_add_plain(idx, g, Mc), reps=10)
    host = host_ms(lambda: K.rows_scatter_add(idx, g, Mc))
    C = g.shape[2]
    keep = (idx >= 0) & (idx < Mc)
    flat = torch.where(
        keep, idx.long() + Mc * torch.arange(BV, device=idx.device)[:, None],
        BV * Mc).reshape(-1)
    gflat = g.reshape(-1, C)
    acc = torch.zeros((BV * Mc + 1, C), device=g.device)
    lib = cuda_ms(lambda: acc.index_add_(0, flat, gflat))
    b, by = bound_ms(nbytes(idx, g) + BV * C * Mc * 4,
                     C * int(keep.sum()))
    log(f"rows_scatter_add: {ms:.4f} ms, plain {plain:.4f} ms, index_add_ "
        f"{lib:.4f} ms, bound {b:.4f} ms ({by}); {host:.4f} ms per call on "
        f"the host clock")
    rows.append(dict(name="rows_scatter_add", max_abs_err=err, ms=ms,
                     plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib))

    table = []
    for r in rows:
        table.append(dict(
            name=r["name"], route="cuda", source=SOURCES[r["name"]],
            replaces=TPU_KERNELS[r["name"]],
            launches=state["launches"][r["name"]],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"],
        ))
    return table


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace 20 post-gate steps with torch.profiler")
    cli = ap.parse_args()

    t_start = time.perf_counter()
    phase_device()
    sys.path.insert(0, REPO)
    import torch

    phase_build()
    state = phase_main_path(cli.profile)
    phase_checks(state)
    table = phase_kernels(state)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
