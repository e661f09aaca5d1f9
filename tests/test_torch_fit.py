"""The port's staged mask fit against the JAX package's ``smplify.fit``.

* f64 trajectory: 60 iterations with the gate at step 20, so the mask
  term is live for 39 steps, against the JAX fit in f64 on its XLA route
  (``STAY_INSIDE = CONTOUR_MATCH = "xla"``).  The JAX side runs in one
  subprocess with ``jax_enable_x64`` (flipping it in the test process
  would leak into other tests) and hands its model, prior, observations,
  initial state and results over as numpy.  Tolerance: 1e-7 relative on
  the loss trace and 1e-7 of each parameter block's scale, the drift of
  f64 rounding in two operation orders over 60 Adam steps.
* f32 short fit against the JAX Pallas route (interpret mode):
  1e-3 relative on the loss trace, because the Pallas sampler rounds its
  hinge weights to bf16 and f32 fits drift apart from there.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bodyfitting_tpu.fitting import body_fitting as jbf
from bodyfitting_tpu.fitting import smplify as jfit
from bodyfitting_tpu.losses import silhouette as jsil
from bodyfitting_tpu.losses.priors import synthetic_gmm_prior
from bodyfitting_tpu.models import body_model as jbm
from bodyfitting_torch.convert import body_model_from_numpy
from bodyfitting_torch.fitting import body_fitting as tbf
from bodyfitting_torch.fitting import smplify as tfit
from tests.torch_port_util import (
    arrays_of, torch_model, torch_obs, torch_params, torch_prior,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMSIZE = 96
N_FRAMES = 2
_STATIC = ("model_type", "parents", "neck_chain", "num_betas",
           "num_expressions", "num_hand_pca", "hand_use_pca",
           "flat_hand_mean", "use_face_contour")


def _ring(n, dist=2.5, focal=110.0):
    c2ws, Ks = [], []
    for th in np.linspace(0, 2 * np.pi, n, endpoint=False):
        eye = np.array([dist * np.sin(th), 0.0, dist * np.cos(th)])
        z = -eye / np.linalg.norm(eye)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        c2w = np.eye(4)
        c2w[:3, :3] = np.stack([x, y, z], 1)
        c2w[:3, 3] = eye
        c2ws.append(c2w.astype(np.float32))
        Ks.append(np.array([[focal, 0, IMSIZE / 2], [0, focal, IMSIZE / 2],
                            [0, 0, 1]], np.float32))
    return c2ws, Ks


def _project(pts, c2w, K):
    w2c = np.linalg.inv(c2w)
    cam = pts @ w2c[:3, :3].T + w2c[:3, 3]
    uv = cam @ K.T
    return uv[:, :2] / uv[:, 2:3]


def _frame_inputs(model, seed):
    """Keypoints (3 views) and masks (2 views) of a ground-truth body."""
    from scipy import ndimage

    rng = np.random.default_rng(seed)
    gt = jbm.BodyParams.zeros(model)
    gt = dataclasses.replace(
        gt,
        body_pose=jnp.asarray(rng.normal(scale=0.15, size=63), jnp.float32),
        betas=jnp.asarray(rng.normal(scale=0.5, size=10), jnp.float32),
        global_orient=jnp.asarray([0.1, 0.3, 0.0], jnp.float32),
    )
    out = jbm.forward(model, gt)
    scale = 0.3 * 1.15
    joints = (np.asarray(out.joints) + [0.05, 0.0, 0.02]) * scale
    verts = (np.asarray(out.vertices) + [0.05, 0.0, 0.02]) * scale
    c2ws, Ks = _ring(3)
    kps = []
    for c2w, K in zip(c2ws, Ks):
        uv = _project(joints, c2w, K) + rng.normal(scale=0.5,
                                                   size=(len(joints), 2))
        kp = np.concatenate([uv, np.ones((len(uv), 1))], 1).astype(np.float32)
        face = np.concatenate([kp[67 + 51:], kp[67:67 + 51]])  # OpenPose order
        kps.append(dict(pose=kp[:25], hand_left=kp[25:46],
                        hand_right=kp[46:67], face=face))
    masks = []
    for c2w, K in zip(c2ws[:2], Ks[:2]):
        uv = np.round(_project(verts, c2w, K)).astype(int)
        m = np.zeros((IMSIZE, IMSIZE), bool)
        ok = (uv >= 0).all(1) & (uv < IMSIZE).all(1)
        m[uv[ok, 1], uv[ok, 0]] = True
        m = ndimage.binary_fill_holes(ndimage.binary_dilation(m,
                                                              iterations=3))
        masks.append(m.astype(np.float32))
    return c2ws, Ks, kps, masks


def _problem(model, crop_hw=(40, 96)):
    obs = []
    for f in range(N_FRAMES):
        c2ws, Ks, kps, masks = _frame_inputs(model, seed=10 + f)
        obs.append(jbf.build_observations(
            c2ws, Ks, kps, use_hand_face=True, masks=masks,
            mask_c2ws=c2ws[:2], mask_Ks=Ks[:2], mask_num_views=3,
            mask_imsize=IMSIZE, contour_resample=64, build_sdf=False,
            mask_crop=True, mask_crop_hw=crop_hw,
        ))
    return obs


def _config(**kw):
    return dict(num_iters=60, use_mask=True, stage_gate_den=3,
                imsize=float(IMSIZE), **kw)


def _jax_f64_side(path):
    """Subprocess body: the JAX f64 fit, saved for the test process."""
    jax.config.update("jax_enable_x64", True)
    model = jbm.synthetic_model("smplx", num_verts=400, seed=7)
    obs32 = _problem(model)
    f64 = lambda t: jax.tree.map(  # noqa: E731
        lambda x: x.astype(jnp.float64)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, t)
    model64 = f64(model)
    obs = [f64(o) for o in obs32]
    prior = synthetic_gmm_prior(dtype=jnp.float64)
    init = [f64(jfit.FitParams.init(model)) for _ in obs]
    jsil.STAY_INSIDE = jsil.CONTOUR_MATCH = "xla"
    params, _, losses = jbf.fit_frames_batched(
        model64, jfit.FitConfig(**_config()), obs, init, prior)
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *obs)
    out = {"losses": np.asarray(losses)}
    for k, v in arrays_of(model64).items():
        if isinstance(v, np.ndarray):
            out[f"model.{k}"] = v
    for k, v in arrays_of(stacked).items():
        if isinstance(v, np.ndarray):
            out[f"obs.{k}"] = v
    for k, v in arrays_of(prior).items():
        out[f"prior.{k}"] = v
    for k, v in arrays_of(params.body).items():
        out[f"params.{k}"] = v
    out["params.global_transl"] = np.asarray(params.global_transl)
    out["params.body_scale"] = np.asarray(params.body_scale)
    static = {k: getattr(model, k) for k in _STATIC}
    out["static"] = np.asarray(json.dumps(static))
    np.savez(path, **out)


@pytest.fixture(scope="module")
def jax_f64(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("f64") / "jax_fit.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys; from tests.test_torch_fit import _jax_f64_side; "
         "_jax_f64_side(sys.argv[1])", path],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(path))


def test_f64_staged_mask_trajectory_matches_jax(jax_f64):
    d = jax_f64
    static = json.loads(str(d["static"]))
    static["parents"] = tuple(static["parents"])
    static["neck_chain"] = tuple(static["neck_chain"])
    fields = {k[6:]: v for k, v in d.items() if k.startswith("model.")}
    model = body_model_from_numpy({**fields, **static}, device="cpu")
    assert model.dtype == torch.float64
    from bodyfitting_torch.convert import (
        gmm_prior_from_numpy, observations_from_numpy,
    )

    prior = gmm_prior_from_numpy(
        *(d[f"prior.{k}"] for k in ("means", "precisions",
                                    "log_nll_weights", "mean_pose")),
        dtype=torch.float64, device="cpu")
    obs = observations_from_numpy(
        {k[4:]: v for k, v in d.items() if k.startswith("obs.")},
        batched=True, device="cpu")
    init = tfit.FitParams.init(model, batch=N_FRAMES)
    params, result, losses = tfit.fit(model, tfit.FitConfig(**_config()),
                                      obs, init, prior)
    jl = d["losses"]
    assert losses.shape == jl.shape == (N_FRAMES, 60)
    np.testing.assert_allclose(losses.numpy(), jl, rtol=1e-7)
    # the mask term is live after the gate: the trace has a jump there
    assert np.all(jl[:, 21] > jl[:, 20])
    for name, t in zip(
            [f for f in tfit.bm.BODY_PARAM_FIELDS]
            + ["global_transl", "body_scale"], params.tensors()):
        ref = d[f"params.{name}"]
        np.testing.assert_allclose(
            t.numpy(), ref, rtol=0,
            atol=1e-7 * max(1.0, float(np.abs(ref).max())), err_msg=name)
    assert result["vertices"].shape == (N_FRAMES, 400, 3)


def test_f32_short_fit_matches_jax_pallas():
    model = jbm.synthetic_model("smplx", num_verts=400, seed=7)
    prior = synthetic_gmm_prior()
    obs = _problem(model)
    cfg = dict(_config(), num_iters=15)
    old = jsil.STAY_INSIDE, jsil.CONTOUR_MATCH
    jsil.STAY_INSIDE = jsil.CONTOUR_MATCH = "pallas"
    try:
        _, _, jl = jbf.fit_frames_batched(
            model, jfit.FitConfig(**cfg), obs,
            [jfit.FitParams.init(model)] * N_FRAMES, prior)
    finally:
        jsil.STAY_INSIDE, jsil.CONTOUR_MATCH = old
    tobs = tfit.concat_frames([torch_obs(o) for o in obs])
    tm = torch_model(model)
    _, _, tl = tfit.fit(tm, tfit.FitConfig(**cfg), tobs,
                        tfit.FitParams.init(tm, batch=N_FRAMES),
                        torch_prior(prior))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-3)


def test_mask_term_zero_before_gate():
    model = jbm.synthetic_model("smplx", num_verts=400, seed=7)
    tm = torch_model(model)
    obs = tfit.concat_frames([torch_obs(o) for o in _problem(model)])
    cfg = tfit.FitConfig(**_config())
    loss_model, _, rows = tfit.loss_models(tm, cfg)
    params = tfit.FitParams.init(tm, batch=N_FRAMES)
    prior = torch_prior(synthetic_gmm_prior())
    gate = cfg.num_iters // cfg.stage_gate_den
    at_gate, terms = tfit.fit_loss(loss_model, cfg, params, obs, gate,
                                   prior, mask_vertex_rows=rows)
    assert torch.all(terms["mask_loss"] == 0.0)
    kp_only, _ = tfit.fit_loss(
        loss_model, dataclasses.replace(cfg, use_mask=False), params, obs,
        gate, prior, mask_vertex_rows=rows)
    assert torch.equal(at_gate, kp_only)
    _, late = tfit.fit_loss(loss_model, cfg, params, obs, gate + 1, prior,
                            mask_vertex_rows=rows)
    assert torch.all(late["mask_loss"] > 0.0)


def test_build_observations_matches_jax():
    model = jbm.synthetic_model("smplx", num_verts=400, seed=7)
    c2ws, Ks, kps, masks = _frame_inputs(model, seed=3)
    kw = dict(use_hand_face=True, masks=masks, mask_c2ws=c2ws[:2],
              mask_Ks=Ks[:2], mask_num_views=3, mask_imsize=IMSIZE,
              contour_resample=64, num_views=4)
    for crop in (True, False):
        j = jbf.build_observations(c2ws, Ks, kps, build_sdf=False,
                                   mask_crop=crop, mask_crop_hw=(40, 96),
                                   **kw)
        t = tbf.build_observations(c2ws, Ks, kps, mask_crop=crop,
                                   mask_crop_hw=(40, 96), device="cpu",
                                   **kw)
        for f in dataclasses.fields(t):
            tv, jv = getattr(t, f.name), getattr(j, f.name)
            assert (tv is None) == (jv is None), f.name
            if tv is not None:
                np.testing.assert_allclose(tv[0].numpy(), np.asarray(jv),
                                           rtol=1e-6, atol=1e-6,
                                           err_msg=f.name)
    # a frame whose mask views were all dropped is fully inert
    t = tbf.build_observations(c2ws, Ks, kps, use_hand_face=True, masks=[],
                               mask_num_views=3, mask_imsize=IMSIZE,
                               mask_crop=True, mask_crop_hw=(40, 96),
                               device="cpu")
    assert t.mask_view_valid.sum() == 0 and t.contour_valid.sum() == 0
    with pytest.raises(NotImplementedError):
        tbf.build_observations(c2ws, Ks, kps, True, device="cpu",
                               scan_verts=np.zeros((3, 3)))


def test_fit_frames_batched_and_later_options():
    model = jbm.synthetic_model("smplx", num_verts=400, seed=7)
    tm = torch_model(model)
    obs = [torch_obs(o) for o in _problem(model)]
    init = [tfit.FitParams.init(tm) for _ in obs]
    prior = torch_prior(synthetic_gmm_prior())
    params, result, losses = tbf.fit_frames_batched(
        tm, tfit.FitConfig(**dict(_config(), num_iters=6)), obs, init, prior)
    assert losses.shape == (N_FRAMES, 6) and torch.isfinite(losses).all()
    assert result["vertices"].shape == (N_FRAMES, 400, 3)
    # the initial state is not modified by the fit
    assert torch.equal(init[0].body.body_pose,
                       torch.zeros_like(init[0].body.body_pose))
    for bad in (dict(use_mesh=True), dict(displacement=True)):
        with pytest.raises(NotImplementedError):
            tfit.fit(tm, tfit.FitConfig(num_iters=1, **bad),
                     tfit.concat_frames(obs), tfit.concat_frames(init), prior)
    # JAX compilation options and the scan term's options are refused,
    # not ignored
    for bad in (dict(remat_forward=True), dict(scan_unroll=4)):
        with pytest.raises(ValueError):
            tfit.FitConfig(**bad)
    with pytest.raises(NotImplementedError):
        tfit.FitConfig(mesh_loss_impl="exact")
