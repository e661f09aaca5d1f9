"""Operations and bytes the fits need, from the configuration's shapes
alone, and the H100's published peaks.

The counts are the least work the step's mathematics needs (each input
read once, each output written once; a multiply-add is two operations),
with a step's backward counted at twice its forward.  They do not depend
on how the program launches the work, so whatever a later change fuses,
captures or removes, the count stays.
"""

from __future__ import annotations

import subprocess

# One H100 SXM, NVIDIA's data sheet, dense, at the 700 W limit.
F32_FLOPS_PER_S = 67e12          # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BACKWARD = 2.0                   # a backward pass costs twice its forward

# Per-item operation counts of the pieces of a step.
PROJECT_OPS = 42        # world -> camera (18), intrinsics (18), divide (2) ...
GMOF_OPS = 2 * 8 + 4    # two robustified residuals, confidence squared
MATCH_OPS = 7           # a contour pixel against a candidate vertex
SAMPLE_OPS = 33         # bilinear sample and its two derivatives
LOOKUP_OPS = 17         # bilinear sample, value only
TRILINEAR_OPS = 40      # 8 taps, weights, out-of-volume term
ADAM_OPS = 12


def bound_s(nbytes: float, flops: float):
    """``(seconds, by)``: the least time for the work on one H100."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them, or
    ``"not read"``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip() or "not read"


def forward_ops(rows: int, joints: int, coeffs: int, pose_feats: int) -> float:
    """One frame's skinned forward over ``rows`` vertex rows: shape and
    expression blend shapes (``coeffs``), pose blend shapes
    (``pose_feats``), the joints folded from the shape coefficients,
    rotations, the kinematic chain and skinning (``W A`` and the 3 x 4
    apply)."""
    blend = 2 * (coeffs + pose_feats) * 3 * rows
    joint = 2 * coeffs * 3 * joints + 40 * joints + 128 * joints
    skin = rows * (2 * joints * 12 + 24)
    return float(blend + joint + skin)


def keypoint_ops(n_joints: int, views: int) -> float:
    """Projection and robust residual of every joint in every view, and
    the priors (an 8-component 69-D max-mixture, angle, shape)."""
    return float(n_joints * views * (PROJECT_OPS + GMOF_OPS)
                 + 8 * (2 * 69 * 69 + 3 * 69) + 40)


def mask_rows(cfg) -> int:
    """The vertex rows the step of a multi-view fit reads: the
    vertex-picked joints and the landmark triangles' corners, and with
    masks every 4th vertex (one merged model before and after the
    gate)."""
    m = cfg["model"]
    strided = -(-m["num_verts"] // 4) if cfg["fit"].get("use_mask") else 0
    return strided + m["vertex_joints"] \
        + 3 * (m["face_landmarks"] + m["contour_landmarks"])


def silhouette(cfg, frames: int):
    """``(operations, bytes)`` of one post-gate step's silhouette work
    for ``frames`` frames: the stay-inside sample at every strided vertex
    of every mask view, the matched-pixel lookup, the contour match and
    its scatter, each reading its inputs and writing its outputs once."""
    r = cfg["rig"]
    BV, P, M = frames * r["mask_views"], r["contour_points"], \
        -(-cfg["model"]["num_verts"] // 4)
    ops = BV * (SAMPLE_OPS * M + LOOKUP_OPS * P + MATCH_OPS * P * M + 2 * P)
    nbytes = BV * (M * 8 + 6 * M * 4          # sample: points in, rows out
                   + P * 8 + 6 * P * 4        # lookup
                   + P * 8 + M * 12 + P * 20  # match: pixels, points, flags
                   + P * 12 + 2 * M * 4)      # scatter: rows in, grads out
    return float(ops), float(nbytes)


def mask_step_ops(cfg, frames: int):
    """``(pre-gate, post-gate)`` operations of one step of a multi-view
    fit; without masks the two are alike."""
    m, r = cfg["model"], cfg["rig"]
    J, rows = m["num_joints"], mask_rows(cfg)
    fwd = forward_ops(rows, J, m["betas"] + m["expressions"],
                      9 * (J - 1)) + keypoint_ops(r["keypoints"], r["views"])
    post = fwd
    if cfg["fit"].get("use_mask"):
        post = fwd + r["mask_views"] * -(-m["num_verts"] // 4) \
            * PROJECT_OPS + silhouette(cfg, 1)[0]
    params = m["betas"] + 3 * 7 + 3 * m["body_joints"] + 2 * 6 + 4
    return tuple(frames * ((1 + BACKWARD) * f + ADAM_OPS * params)
                 for f in (fwd, post))


def gate_step(cfg) -> int:
    """The last step before the mask or scan term joins the fit."""
    return cfg["fit"]["num_iters"] // cfg["fit"]["stage_gate_den"]


def mask_fit_ops(cfg, frames: int) -> float:
    """Operations of a whole multi-view fit (the gate's steps and the
    rest)."""
    n, gate = cfg["fit"]["num_iters"], gate_step(cfg)
    pre, post = mask_step_ops(cfg, frames)
    return (gate + 1) * pre + (n - gate - 1) * post


def scan_step_ops(cfg):
    """``(pre-gate, post-gate, displacement)`` operations of one step of
    the scan fit: keypoints through the vertex-picked rows; after the gate
    the whole model and the trilinear scan distance at every vertex;
    SMPL+D's vertex normals, scan distance, normal and smoothness terms."""
    m, r = cfg["model"], cfg["rig"]
    J, V, F = m["num_joints"], m["num_verts"], m["num_faces"]
    pre = forward_ops(m["vertex_joints"], J, m["betas"], 9 * (J - 1)) \
        + keypoint_ops(r["keypoints"], r["views"])
    post = pre + forward_ops(V, J, m["betas"], 9 * (J - 1)) \
        + V * TRILINEAR_OPS
    disp = F * 40 + V * 12 + V * (TRILINEAR_OPS + 8) + F * 30
    params = m["betas"] + 3 + 3 * m["body_joints"] + 4
    return ((1 + BACKWARD) * pre + ADAM_OPS * params,
            (1 + BACKWARD) * post + ADAM_OPS * params,
            (1 + BACKWARD) * disp + ADAM_OPS * 3 * V)


def scan_fit_ops(cfg) -> float:
    n, gate = cfg["fit"]["num_iters"], gate_step(cfg)
    pre, post, disp = scan_step_ops(cfg)
    return (gate + 1) * pre + (n - gate - 1) * post + n * disp


def volume_bytes(cfg) -> float:
    """The volume build's least traffic: every cell centre read once, the
    scan's triangles and vertices read once, each cell's distance and
    face written once."""
    R, Fs = cfg["fit"]["sdf_resolution"], cfg["scan"]["num_faces"]
    Vs = cfg["scan"]["num_verts"]
    return float(R ** 3 * 12 + Fs * 36 + Vs * 12 + R ** 3 * 8)
