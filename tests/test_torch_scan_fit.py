"""The port's scan fit (SMPLify + SMPL+D) against the JAX package's.

* f64 trajectories, ``mesh_loss_impl="sdf"`` and ``"exact"``: 30 body
  iterations with the point-to-scan term on after step 10, then 30
  displacement iterations, against JAX's unbatched ``smplify.fit`` in
  f64.  The JAX side runs in one subprocess with ``jax_enable_x64``
  (flipping it in the test process would leak into other tests) and
  hands its model, prior, observations (the distance volume included)
  and results over as numpy.  Tolerance: 1e-7 relative on the loss trace
  and 1e-7 of each parameter block's scale, the drift of f64 rounding in
  two operation orders over 60 Adam steps.  The displacement stage
  amplifies rounding about 1.6x a step: at 45 + 45 steps the two
  packages stay within 1e-15 through the body stage and part by 5e-7
  (sdf) and 8e-6 (exact) at the last displacement step, so the test
  runs 30 + 30.  Both packages start from their own ``hmr_init`` mean
  pose.
* ``build_observations``' scan fields against JAX's in f32: the height,
  scale prior and scan arrays exactly, the volume's ``face_idx`` exactly
  and its distances to f32 rounding.
* The scan problem is ``chip_smoke.make_scan_problem`` at a small size:
  a 92-vertex synthetic SMPL model, its posed surface subdivided once
  (720 faces) and pushed out by 5-15 mm, 4 ring views at 256².
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
from bodyfitting_tpu.losses.priors import synthetic_gmm_prior
from bodyfitting_tpu.models import body_model as jbm
from bodyfitting_torch.convert import (
    body_model_from_numpy,
    gmm_prior_from_numpy,
    observations_from_numpy,
)
from bodyfitting_torch.fitting import body_fitting as tbf
from bodyfitting_torch.fitting import smplify as tfit
from tests.torch_port_util import arrays_of, torch_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 30
IMSIZE = 256
SDF_RES = 24
IMPLS = ("sdf", "exact")
_STATIC = ("model_type", "parents", "neck_chain", "num_betas",
           "num_expressions", "num_hand_pca", "hand_use_pca",
           "flat_hand_mean", "use_face_contour")


def _jax_model():
    return jbm.spin_joint_mapper_for_smpl(
        jbm.synthetic_model("smpl", num_verts=96, seed=5, mesh="sphere"))


def _scan_problem(jax_model):
    """The scan problem, built by ``chip_smoke.make_scan_problem`` on the
    port's copy of ``jax_model`` (CPU, f32)."""
    from chip_smoke import make_scan_problem

    return make_scan_problem(torch_model(jax_model), n_views=4,
                             imsize=IMSIZE, subdivisions=1, seed=0)


def _config(impl):
    return dict(num_iters=ITERS, imsize=float(IMSIZE), use_mesh=True,
                displacement=True, mesh_loss_impl=impl)


def _jax_f64_side(path):
    """Subprocess body: the JAX f64 scan fits, saved for the test
    process."""
    jax.config.update("jax_enable_x64", True)
    model = _jax_model()
    c2ws, Ks, kps, sv, sf = _scan_problem(model)
    obs32 = jbf.build_observations(c2ws, Ks, kps, use_hand_face=False,
                                   scan_verts=sv, scan_faces=sf,
                                   sdf_resolution=SDF_RES)
    betas, poses = jbf.hmr_init(None, c2ws[0])
    init32 = jbf.init_params_from_hmr(model, betas, poses)
    f64 = lambda t: jax.tree.map(  # noqa: E731
        lambda x: x.astype(jnp.float64)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, t)
    model64, obs, init = f64(model), f64(obs32), f64(init32)
    prior = synthetic_gmm_prior(dtype=jnp.float64)
    out = {}
    for impl in IMPLS:
        cfg = jfit.FitConfig(**_config(impl))
        params, result, losses = jax.jit(
            lambda o, i: jfit.fit(model64, cfg, o, i, prior))(obs, init)
        out[f"{impl}.losses"] = np.asarray(losses)
        out[f"{impl}.displacement"] = np.asarray(result["displacement"])
        out[f"{impl}.vertices"] = np.asarray(result["vertices"])
        for k, v in arrays_of(params.body).items():
            out[f"{impl}.params.{k}"] = v
        out[f"{impl}.params.global_transl"] = np.asarray(params.global_transl)
        out[f"{impl}.params.body_scale"] = np.asarray(params.body_scale)
    for k, v in arrays_of(model64).items():
        if isinstance(v, np.ndarray):
            out[f"model.{k}"] = v
    for k, v in arrays_of(obs).items():
        if isinstance(v, np.ndarray):
            out[f"obs.{k}"] = v
    for k, v in arrays_of(obs.scan_volume).items():
        out[f"vol.{k}"] = v
    for k, v in arrays_of(prior).items():
        out[f"prior.{k}"] = v
    out["poses"] = poses
    out["c2w0"] = c2ws[0]
    static = {k: getattr(model, k) for k in _STATIC}
    out["static"] = np.asarray(json.dumps(static))
    np.savez(path, **out)


@pytest.fixture(scope="module")
def jax_f64(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("scan_f64") / "jax_fit.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys; from tests.test_torch_scan_fit import _jax_f64_side; "
         "_jax_f64_side(sys.argv[1])", path],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=900,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(path))


def _port_side(d):
    static = json.loads(str(d["static"]))
    static["parents"] = tuple(static["parents"])
    static["neck_chain"] = tuple(static["neck_chain"])
    fields = {k[6:]: v for k, v in d.items() if k.startswith("model.")}
    model = body_model_from_numpy({**fields, **static}, device="cpu")
    assert model.dtype == torch.float64
    prior = gmm_prior_from_numpy(
        *(d[f"prior.{k}"] for k in ("means", "precisions",
                                    "log_nll_weights", "mean_pose")),
        dtype=torch.float64, device="cpu")
    obs_fields = {k[4:]: v for k, v in d.items() if k.startswith("obs.")}
    obs_fields["scan_volume"] = {k[4:]: v for k, v in d.items()
                                 if k.startswith("vol.")}
    obs = observations_from_numpy(obs_fields, device="cpu")
    betas, poses = tbf.hmr_init(None, d["c2w0"])
    np.testing.assert_array_equal(poses, d["poses"])
    init = tbf.init_params_from_hmr(model, betas, poses)
    return model, prior, obs, init


@pytest.mark.parametrize("impl", IMPLS)
def test_f64_scan_fit_trajectory_matches_jax(jax_f64, impl):
    d = jax_f64
    model, prior, obs, init = _port_side(d)
    params, result, losses = tbf.fit_scan(
        model, tfit.FitConfig(**_config(impl)), obs, init, prior)
    jl = d[f"{impl}.losses"]
    assert losses.shape == jl.shape == (2 * ITERS,)
    np.testing.assert_allclose(losses.numpy(), jl, rtol=1e-7)
    # the point-to-scan term is off up to the gate and live after it
    cfg = tfit.FitConfig(**_config(impl))
    loss_model, joints_model, _ = tfit.loss_models(model, cfg)
    gate = ITERS // 3
    pc = [tfit.fit_loss(loss_model, cfg, init, obs, s, prior,
                        joints_model=joints_model)[1]["pc_loss"]
          for s in (gate, gate + 1)]
    assert float(pc[0]) == 0.0 and float(pc[1]) > 0.0
    # the displacement stage descends
    assert jl[-5:].mean() < jl[ITERS:ITERS + 5].mean()
    for name, t in zip(list(tfit.bm.BODY_PARAM_FIELDS)
                       + ["global_transl", "body_scale"], params.tensors()):
        ref = d[f"{impl}.params.{name}"]
        np.testing.assert_allclose(
            t[0].numpy(), ref, rtol=0,
            atol=1e-7 * float(np.abs(ref).max(initial=1.0)), err_msg=name)
    for key in ("vertices", "displacement"):
        ref = d[f"{impl}.{key}"]
        assert result[key].shape == ref.shape
        np.testing.assert_allclose(
            result[key].numpy(), ref, rtol=0,
            atol=1e-7 * float(np.abs(ref).max(initial=1.0)), err_msg=key)


def test_build_observations_scan_fields_match_jax():
    model = _jax_model()
    c2ws, Ks, kps, sv, sf = _scan_problem(model)
    j = jbf.build_observations(c2ws, Ks, kps, use_hand_face=False,
                               scan_verts=sv, scan_faces=sf,
                               sdf_resolution=SDF_RES)
    t = tbf.build_observations(c2ws, Ks, kps, use_hand_face=False,
                               scan_verts=sv, scan_faces=sf,
                               sdf_resolution=SDF_RES, device="cpu")
    for name in ("w2cs", "Ks", "keypoints", "view_mask", "constant_scale",
                 "num_views_used", "scan_verts", "scan_faces",
                 "scan_height"):
        np.testing.assert_array_equal(getattr(t, name)[0].numpy(),
                                      np.asarray(getattr(j, name)),
                                      err_msg=name)
    assert t.scan_faces.dtype == torch.int64
    jv, tv = j.scan_volume, t.scan_volume
    np.testing.assert_array_equal(tv.face_idx[0].numpy(),
                                  np.asarray(jv.face_idx))
    np.testing.assert_array_equal(tv.origin[0].numpy(), np.asarray(jv.origin))
    np.testing.assert_array_equal(tv.spacing.numpy(),
                                  np.asarray(jv.spacing)[None])
    np.testing.assert_allclose(tv.dist[0].numpy(), np.asarray(jv.dist),
                               rtol=1e-6, atol=1e-6)
    no_vol = tbf.build_observations(c2ws, Ks, kps, use_hand_face=False,
                                    scan_verts=sv, scan_faces=sf,
                                    build_sdf=False, device="cpu")
    assert no_vol.scan_volume is None


def test_mean_pose_init_matches_jax():
    model = _jax_model()
    tm = torch_model(model)
    rng = np.random.default_rng(0)
    for _ in range(3):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = q * np.sign(np.linalg.det(q))
        jb, jp = jbf.hmr_init(None, c2w)
        tb, tp = tbf.hmr_init(None, c2w)
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(tp, jp)
        ji = jbf.init_params_from_hmr(model, jb, jp)
        ti = tbf.init_params_from_hmr(tm, tb, tp)
        for f in tfit.bm.BODY_PARAM_FIELDS:
            np.testing.assert_array_equal(getattr(ti.body, f)[0].numpy(),
                                          np.asarray(getattr(ji.body, f)),
                                          err_msg=f)
    with pytest.raises(NotImplementedError):
        tbf.hmr_init(None, c2w, bundle=object())


def test_scan_fit_refuses_a_batch_of_scans():
    model = _jax_model()
    tm = torch_model(model)
    c2ws, Ks, kps, sv, sf = _scan_problem(model)
    obs = tbf.build_observations(c2ws, Ks, kps, use_hand_face=False,
                                 scan_verts=sv, scan_faces=sf, build_sdf=False,
                                 device="cpu")
    two = tfit.concat_frames([obs, obs])
    init = tfit.FitParams.init(tm, batch=2)
    cfg = tfit.FitConfig(**dict(_config("exact"), num_iters=3))
    with pytest.raises(NotImplementedError):
        tfit.fit(tm, cfg, two, init, lambda p: p.new_zeros(p.shape[:-1]))
    no_scan = dataclasses.replace(obs, scan_verts=None, scan_faces=None)
    with pytest.raises(ValueError):
        tfit.fit(tm, cfg, no_scan, tfit.FitParams.init(tm),
                 lambda p: p.new_zeros(p.shape[:-1]))
