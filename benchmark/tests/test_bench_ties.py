"""The allowance for near-ties: where one of the objective's discrete
decisions lies within float32 rounding of its threshold, the reference
evaluated in float32 (standing in for the program) and in float64 decide
it differently and their losses part by the decision's jump; the masked
step's compared gap (``mask_fit.loss_gap`` less ``fit_loss_ties``) stays
inside its limit.  A decision taken wrongly far from its threshold gets
no allowance and fails."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import fitlib, harness
from benchmark.drivers import mask_fit
from benchmark.reference import body
from benchmark.reference import losses as ref

F32, F64 = torch.float32, torch.float64
LIMIT = mask_fit.LIMITS["gate_loss"]
N = 128                                 # image side
CFG = dict(imsize=float(N), mask_weight=5.0)


def _scene(uvs, contour, mask, z=2.0, f=100.0):
    """One frame and one mask view: vertices placed to project at
    ``uvs`` through a camera at ``z`` with focal ``f``; ``mask`` the full
    image (a crop at the origin)."""
    uvs = np.asarray(uvs, np.float64)
    c = N / 2
    verts = np.stack([(uvs[:, 0] - c) * z / f, (uvs[:, 1] - c) * z / f,
                      np.zeros(len(uvs))], -1)
    w2c = np.eye(4)
    w2c[2, 3] = z
    K = np.array([[f, 0, c], [0, f, c], [0, 0, 1.0]])
    P = len(contour)
    obs = dict(mask_w2c=w2c[None, None], mask_K=K[None, None],
               contours=np.asarray(contour, np.float64)[None, None],
               contour_valid=np.ones((1, 1, P)), crops=mask[None, None],
               crop_origins=np.zeros((1, 1, 2)), view_valid=np.ones((1, 1)))
    return verts[None], obs


def _as(dtype, verts, obs):
    return (torch.as_tensor(verts, dtype=dtype),
            {k: torch.as_tensor(v, dtype=dtype) for k, v in obs.items()})


def _readings(verts, obs):
    """``(raw, allowed)``: the float32 evaluation's relative gap from the
    float64 one, before and after the near-ties' allowance."""
    v32, o32 = _as(F32, verts, obs)
    v64, o64 = _as(F64, verts, obs)
    prog = CFG["mask_weight"] * ref.mask_term(CFG, o32, v32).double()
    want = CFG["mask_weight"] * ref.mask_term(CFG, o64, v64)
    ties = CFG["mask_weight"] * ref.mask_term_ties(CFG, o64, v64)
    return (float(mask_fit.loss_gap(prog, want)[0]),
            float(mask_fit.loss_gap(prog, want, ties)[0]))


def _first_flip(make, deltas):
    """The first of ``deltas`` whose scene float32 and float64 decide
    differently (their gap over the limit), and its readings."""
    for d in deltas:
        raw, allowed = _readings(*make(d))
        if raw > LIMIT:
            return d, raw, allowed
    raise AssertionError("no planted near-tie flipped")


def _mask(ones=(), zeros=(), fill=1.0):
    m = np.full((N, N), fill)
    for y, x in ones:
        m[y, x] = 1.0
    for y, x in zeros:
        m[y, x] = 0.0
    return m


def _argmin_tie(d):
    # two vertices 0.7 px from the contour pixel (64, 64): one on its own
    # pixel (inside, weight 1), one on the pixel above (outside, 10)
    uvs = [(64.7, 64.0), (64.0, 63.3 + d)]
    return _scene(uvs, [(64.0, 64.0)], _mask(zeros=[(63, 64)]))


def _trunc_tie(d):
    # one vertex just under the pixel border x = 70: pixel 69 inside,
    # pixel 70 outside
    return _scene([(70.0 - d, 40.5)], [(70.0, 41.0)],
                  _mask(ones=[(40, 69)], zeros=[(40, 70)], fill=0.0))


def _sample_tie(d):
    # the matched pixel reads within rounding of 0.1
    m = _mask()
    m[40, 70] = 0.1 - d
    return _scene([(70.25, 40.5)], [(70.0, 41.0)], m)


@pytest.mark.parametrize("make,deltas", [
    (_argmin_tie, [k * 1e-7 for k in range(-60, 61)]),
    (_trunc_tie, [k * 1e-7 for k in range(1, 200)]),
    (_sample_tie, [1e-10, 1e-9]),
], ids=["argmin", "truncation", "sample"])
def test_planted_mask_tie_reads_inside_limit(make, deltas):
    _, raw, allowed = _first_flip(make, deltas)
    assert raw > LIMIT and allowed <= LIMIT, (raw, allowed)


def test_weight_wrong_far_from_threshold_fails():
    """A weight of 1 where the matched pixel's sample reads 0.05: far from
    0.1, no allowance."""
    m = _mask()
    m[40, 70] = 0.05
    verts, obs = _scene([(70.25, 40.5)], [(70.0, 41.0)], m)
    v64, o64 = _as(F64, verts, obs)
    wrong = dict(o64, crops=o64["crops"].clone())
    wrong["crops"][..., 40, 70] = 0.15
    prog = CFG["mask_weight"] * ref.mask_term(CFG, wrong, v64)
    want = CFG["mask_weight"] * ref.mask_term(CFG, o64, v64)
    ties = CFG["mask_weight"] * ref.mask_term_ties(CFG, o64, v64)
    assert float(ties[0]) == 0.0
    assert float(mask_fit.loss_gap(prog, want, ties)[0]) > LIMIT


@pytest.fixture(scope="module")
def smplx(tmp_path_factory):
    cfg = harness.load_json(harness.HERE, "configs", "smplx_genebody.json")
    paths = fitlib.write_assets(cfg, 17, str(tmp_path_factory.mktemp("yaw")))
    return {d: body.load(paths["model"], "smplx", dtype=d) for d in (F32, F64)}


def _yaw_params(model, deg):
    """Zero parameters but the neck, turned about the vertical so that
    the head's yaw reads ``deg``."""
    dt = model.v_template.dtype
    ts = fitlib.ref_init(model, [dict(global_orient=np.zeros(3),
                                      body_pose=np.zeros(63))], dt, "cpu")
    p = dict(zip(ref.PARAM_FIELDS, ts))
    p["body_pose"][0, 3 * 11 + 1] = -np.deg2rad(deg)    # joint 12, the neck
    return p


def _yaw_case(smplx):
    """A neck turned within float32 rounding of 10.5 degrees, where the
    two precisions take different whole degrees, and a rig that sees the
    keypoints: ``(p32, p64, obs, cfg)``."""
    for k in range(200):
        deg = 10.5 + (k - 100) * 2e-7
        p32, p64 = _yaw_params(smplx[F32], deg), _yaw_params(smplx[F64], deg)
        whole = [int(body.whole_degrees(body.yaw_degrees(
            smplx[d], body.full_pose(smplx[d], p)))[0])
            for d, p in ((F32, p32), (F64, p64))]
        if whole[0] != whole[1]:
            break
    else:
        raise AssertionError("no planted yaw flipped")
    rng = np.random.default_rng(3)
    kp = rng.uniform(200, 300, (1, 4, 135, 3))
    kp[..., 2] = 1.0
    cams = np.eye(4)[None].repeat(4, 0)
    cams[:, 2, 3] = 2.0
    K = np.array([[500.0, 0, 256], [0, 500.0, 256], [0, 0, 1]])

    def obs(dt):
        return dict(w2c=torch.as_tensor(cams[None], dtype=dt),
                    K=torch.as_tensor(np.tile(K, (1, 4, 1, 1)), dtype=dt),
                    keypoints=torch.as_tensor(kp, dtype=dt),
                    view_mask=torch.ones(1, 4, dtype=dt), num_views=4.0,
                    constant_scale=torch.full((1,), 0.3, dtype=dt))

    cfg = dict(fitlib.OBJECTIVE, imsize=512.0, num_iters=600,
               stage_gate_den=3, use_mask=False)
    return p32, p64, obs, cfg


def test_planted_yaw_tie_reads_inside_limit(smplx):
    """The masked step's loss: the reference's branch at the other whole
    degree explains the float32 loss."""
    p32, p64, obs, cfg = _yaw_case(smplx)
    prior = _Zero()
    prog = ref.keypoint_term(cfg, obs(F32), p32, body.forward(
        smplx[F32], p32)[1], prior, True).double()
    want = ref.keypoint_term(cfg, obs(F64), p64, body.forward(
        smplx[F64], p64)[1], prior, True)
    deg = ref.yaw_ties(smplx[F64], p64)
    other = ref.keypoint_term(cfg, obs(F64), p64, body.forward(
        smplx[F64], p64, deg)[1], prior, True)
    assert float(mask_fit.loss_gap(prog, want)[0]) > LIMIT
    assert float(mask_fit.loss_gap(prog, torch.stack([want, other]))[0]) \
        <= LIMIT


def test_planted_yaw_tie_in_followed_steps(smplx):
    """The followed steps: a fit started at the planted yaw parts at step
    0; the reference's branch with that step's whole degree taken the
    other way follows the float32 fit."""
    p32, p64, obs, cfg = _yaw_case(smplx)
    prior = _Zero()

    def loss_fn(model, o):
        def at(i, ts, deg=None):
            return ref.fit_loss(cfg, model, o, dict(zip(ref.PARAM_FIELDS, ts)),
                                i, prior, deg=deg)
        return at

    lrs = ref.body_lrs(cfg)
    prog, _ = ref.follow(loss_fn(smplx[F32], obs(F32)), list(p32.values()),
                         lrs, 3)
    branches = ref.follow_branches(loss_fn(smplx[F64], obs(F64)),
                                   list(p64.values()), lrs, 3, smplx[F64])
    gap = ((prog.double() - branches).abs() / branches.abs()).amax(2)
    limit = mask_fit.LIMITS["steps"]
    assert len(branches) == 2 and float(gap[0, 0]) > limit
    assert float(gap.min(0).values[0]) <= limit


class _Zero:
    """A pose prior of nought: the yaw's jump alone."""

    def __call__(self, pose69):
        return pose69.new_zeros(pose69.shape[0])


# ---------------------------------------------------------------------------
# The masked step's gradient: the same decisions, and the "stay inside"
# sample's cell and the pose prior's component, whose flips move the
# gradient but not the loss
# ---------------------------------------------------------------------------

GRAD_LIMIT = mask_fit.LIMITS["gate_grad"]
# A flip shows when the two gradients' norms part by more than this
# (float32's own rounding reads ~1e-6 here); after the allowance they
# read at rounding.
FLIP, ROUNDING = 1e-3, 1e-5


def _grad(dtype, verts, obs):
    """The mask term's gradient in the vertices ``[1, 3 M]``."""
    v, o = _as(dtype, verts, obs)
    v.requires_grad_(True)
    loss = CFG["mask_weight"] * ref.mask_term(CFG, o, v).sum()
    return torch.autograd.grad(loss, v)[0].double().reshape(1, -1)


def _grad_readings(verts, obs):
    """``(raw, allowed)``: the float32 gradient's ``grad_gap`` from the
    float64 one (one leaf: every vertex coordinate), before and after the
    near-ties' allowance, with the scene's Jacobian from vertices to
    pixels."""
    v64, o64 = _as(F64, verts, obs)
    M = v64.shape[1]
    jac = torch.autograd.functional.jacobian(
        lambda v: ref.project(v.reshape(1, M, 3), o64["mask_w2c"],
                              o64["mask_K"]), v64.reshape(-1))
    uv = ref.project(v64, o64["mask_w2c"], o64["mask_K"])
    band = ref.projection_band(v64, o64["mask_w2c"], o64["mask_K"])
    allow = CFG["mask_weight"] * ref.mask_grad_ties(CFG, o64, [3 * M], uv,
                                                    band, jac)
    got, want = _grad(F32, verts, obs), _grad(F64, verts, obs)
    return (float(fitlib.grad_gap([got], [want])[0]),
            float(fitlib.grad_gap([got], [want], allow=allow)[0]))


def _first_grad_flip(make, deltas):
    for d in deltas:
        raw, allowed = _grad_readings(*make(d))
        if raw > FLIP:
            return d, raw, allowed
    raise AssertionError("no planted near-tie flipped the gradient")


def _cell_tie(d):
    # a sample coordinate just under the border x = 70 where the mask
    # steps from 1 to 0; the contour pixel pulls the vertex along y
    s = (N - 1) / N
    u = (70.0 - d) / s
    m = _mask(fill=1.0)
    m[:, 70:] = 0.0
    return _scene([(u, 40.5)], [(u, 45.0)], m)


@pytest.mark.parametrize("make,deltas", [
    (_argmin_tie, [k * 1e-7 for k in range(-60, 61)]),
    (_trunc_tie, [k * 1e-7 for k in range(1, 200)]),
    (_sample_tie, [1e-10, 1e-9]),
    (_cell_tie, [k * 1e-7 for k in range(1, 200)]),
], ids=["argmin", "truncation", "sample", "cell"])
def test_planted_mask_tie_gradient_reads_inside_limit(make, deltas):
    _, raw, allowed = _first_grad_flip(make, deltas)
    assert raw > FLIP and allowed <= ROUNDING, (raw, allowed)


def test_gradient_weight_wrong_far_from_threshold_fails():
    """The gradient of a weight of 1 where the matched pixel's sample
    reads 0.05: no allowance."""
    m = _mask()
    m[40, 70] = 0.05
    verts, obs = _scene([(70.25, 40.5)], [(70.0, 41.0)], m)
    wrong = dict(obs, crops=obs["crops"].copy())
    wrong["crops"][..., 40, 70] = 0.15
    v64, o64 = _as(F64, verts, obs)
    jac = torch.autograd.functional.jacobian(
        lambda v: ref.project(v.reshape(1, 1, 3), o64["mask_w2c"],
                              o64["mask_K"]), v64.reshape(-1))
    allow = ref.mask_grad_ties(CFG, o64, [3], ref.project(
        v64, o64["mask_w2c"], o64["mask_K"]), ref.projection_band(
        v64, o64["mask_w2c"], o64["mask_K"]), jac)
    assert float(allow.max()) == 0.0
    got, want = _grad(F64, verts, wrong), _grad(F64, verts, obs)
    assert float(fitlib.grad_gap([got], [want], allow=allow)[0]) \
        > GRAD_LIMIT


def _two_components(dtype):
    """A pose prior of two unit Gaussians, at 0.3 and at (-0.3, 0.4) on
    the first two coordinates, weighted so that they tie at the origin."""
    prior = ref.GMMPrior.__new__(ref.GMMPrior)
    means = torch.zeros(2, 69, dtype=dtype)
    means[0, 0], means[1, 0], means[1, 1] = 0.3, -0.3, 0.4
    prior.means = means
    prior.prec = torch.eye(69, dtype=dtype).repeat(2, 1, 1)
    prior.logw = torch.tensor([0.0, 0.08], dtype=dtype)
    return prior


def _prior_grads(x):
    """The pose prior's gradient in ``body_pose`` at ``(x, 0, ...)``, in
    float32 and in float64, and the float64 pose."""
    w2 = 4.78 ** 2
    grads = {}
    for F in (F32, F64):
        q = torch.zeros(1, 63, dtype=F)
        q[0, 0] = x
        q.requires_grad_(True)
        pose69 = torch.cat([q, q.new_zeros(1, 6)], 1)
        grads[F] = torch.autograd.grad(
            w2 * _two_components(F)(pose69).sum(), q)[0].double()
    return grads, q.detach()


def _prior_readings(grads, pose):
    """``(allowance, raw, allowed)`` of the ``body_pose`` leaf."""
    p = dict(zip(ref.PARAM_FIELDS, fitlib.ref_init(
        _Model(), [dict(global_orient=np.zeros(3), body_pose=np.zeros(63))],
        F64, "cpu")))
    p["body_pose"] = pose
    allow = ref.gmm_grad_ties(dict(pose_prior_weight=4.78),
                              _two_components(F64), p,
                              [p[f].shape[1] for f in ref.PARAM_FIELDS])
    leaf = allow[:, ref.PARAM_FIELDS.index("body_pose")][:, None]
    got, want = [grads[F32]], [grads[F64]]
    return (float(leaf[0, 0]), float(fitlib.grad_gap(got, want)[0]),
            float(fitlib.grad_gap(got, want, allow=leaf)[0]))


def test_pose_prior_component_tie():
    """A pose within rounding of the two components' border takes the
    other component in float32: the allowance explains the gradient's
    jump."""
    for k in range(1, 2000):
        x = (-1) ** k * (k // 2) * 1e-9
        grads, pose = _prior_grads(x)
        _, raw, allowed = _prior_readings(grads, pose)
        if raw > FLIP:
            break
    else:
        raise AssertionError("no planted component tie flipped")
    assert allowed <= ROUNDING, (x, raw, allowed)


def test_pose_prior_wrong_far_from_border_fails():
    """Far from the border no allowance, and a gradient twice the
    reference's fails."""
    grads, pose = _prior_grads(1e-3)
    grads[F32] = 2 * grads[F64]
    allow, _, allowed = _prior_readings(grads, pose)
    assert allow == 0.0 and allowed > GRAD_LIMIT


class _Model:
    kind, num_body_joints = "smplx", 21
