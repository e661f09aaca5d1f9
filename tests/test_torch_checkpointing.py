"""The port's ``fit_resumable`` (``fitting/checkpointing.py``).

* In the port (f32, CPU): the staged mask fit of ``test_torch_fit.py``
  (2 frames, 60 iterations, the gate at step 20) run in chunks of 17 with
  a checkpoint, and a run that dies at step 45 and is resumed by a fresh
  call, both equal an unbroken ``smplify.fit`` bit for bit: parameters,
  loss trace and result.  The same for the SMPL+D displacement stage of a
  small scan fit (chunks of 7, a death in the displacement stage).
* Against the JAX package's ``fit_resumable`` in f64 on one frame of the
  same problem (chunks of 20): 1e-7 relative on the loss trace and 1e-7
  of each parameter block's scale, the precision ``test_torch_fit.py``
  claims (JAX keeps its loss history in a float32 buffer, whose rounding,
  <= 6e-8, is inside that).  The JAX side runs in a subprocess with
  ``jax_enable_x64``.
* A save torn mid-write leaves the previous checkpoint in place, and the
  stale ``.tmp`` does not disturb a resume.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bodyfitting_tpu.fitting import smplify as jfit
from bodyfitting_tpu.losses.priors import synthetic_gmm_prior
from bodyfitting_tpu.models import body_model as jbm
from bodyfitting_torch.fitting import body_fitting as tbf
from bodyfitting_torch.fitting import checkpointing as ck
from bodyfitting_torch.fitting import smplify as tfit
from tests.test_torch_fit import _config, _problem
from tests.torch_port_util import arrays_of, torch_model, torch_obs, torch_prior

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def mask_problem():
    jm = jbm.synthetic_model("smplx", num_verts=400, seed=7)
    obs = tfit.concat_frames([torch_obs(o) for o in _problem(jm)])
    model = torch_model(jm)
    return (model, obs, tfit.FitParams.init(model, batch=2),
            torch_prior(synthetic_gmm_prior()))


class _Died(Exception):
    pass


def _dies_at(monkeypatch, step):
    """Make the next ``fit_resumable`` body stage raise at ``step``."""
    make = tfit.make_step_fn

    def make_dying(*a, **kw):
        inner = make(*a, **kw)

        def step_fn(i):
            if i == step:
                raise _Died
            return inner(i)
        return step_fn
    monkeypatch.setattr(ck.smplify, "make_step_fn", make_dying)


def _assert_same(a, b):
    (pa, ra, la), (pb, rb, lb) = a, b
    assert torch.equal(la, lb)
    for x, y in zip(pa.tensors(), pb.tensors()):
        assert torch.equal(x, y)
    assert set(ra) == set(rb)
    for k in ra:
        assert torch.equal(ra[k], rb[k]), k


def test_chunked_and_resumed_equal_unbroken_fit(mask_problem, tmp_path,
                                                monkeypatch):
    model, obs, init, prior = mask_problem
    cfg = tfit.FitConfig(**_config())
    ref = tfit.fit(model, cfg, obs, init, prior)
    assert ref[2].shape == (2, 60)
    path = str(tmp_path / "fit.ckpt")
    _assert_same(ck.fit_resumable(model, cfg, obs, init, prior, path,
                                  chunk_size=17), ref)
    saved = torch.load(path, weights_only=True)
    assert saved["step"] == saved["count"] == 60
    assert np.load(path + ".losses.npy").shape == (60, 2)
    # a run that dies past the gate, then a fresh call that resumes it
    path = str(tmp_path / "resume.ckpt")
    with monkeypatch.context() as m:
        _dies_at(m, 45)
        with pytest.raises(_Died):
            ck.fit_resumable(model, cfg, obs, init, prior, path,
                             chunk_size=17)
    assert torch.load(path, weights_only=True)["step"] == 34
    _assert_same(ck.fit_resumable(model, cfg, obs, init, prior, path,
                                  chunk_size=17), ref)
    # no checkpoint path: the same trajectory, nothing written
    _assert_same(ck.fit_resumable(model, cfg, obs, init, prior,
                                  chunk_size=25), ref)


def test_torn_tmp_never_replaces_a_checkpoint(mask_problem, tmp_path,
                                              monkeypatch):
    model, obs, init, prior = mask_problem
    cfg = tfit.FitConfig(**dict(_config(), num_iters=24))
    ref = tfit.fit(model, cfg, obs, init, prior)
    path = str(tmp_path / "torn.ckpt")
    real_save = torch.save
    saves = []

    def torn_save(obj, f):
        saves.append(f)
        if len(saves) == 2:             # the second chunk's save tears
            with open(f, "wb") as fh:
                fh.write(b"\x80\x02half a checkpoint")
            raise OSError("disk full")
        real_save(obj, f)
    with monkeypatch.context() as m:
        m.setattr(ck.torch, "save", torn_save)
        with pytest.raises(OSError):
            ck.fit_resumable(model, cfg, obs, init, prior, path,
                             chunk_size=10)
    assert saves == [path + ".tmp"] * 2
    assert os.path.exists(path + ".tmp")
    assert torch.load(path, weights_only=True)["step"] == 10
    _assert_same(ck.fit_resumable(model, cfg, obs, init, prior, path,
                                  chunk_size=10), ref)
    assert not os.path.exists(path + ".tmp")


def test_displacement_stage_chunked_and_resumed(tmp_path, monkeypatch):
    from chip_smoke import make_scan_problem

    jm = jbm.spin_joint_mapper_for_smpl(
        jbm.synthetic_model("smpl", num_verts=96, seed=5, mesh="sphere"))
    model = torch_model(jm)
    c2ws, Ks, kps, sv, sf = make_scan_problem(model, n_views=4, imsize=256,
                                              subdivisions=1, seed=0)
    obs = tbf.build_observations(c2ws, Ks, kps, use_hand_face=False,
                                 scan_verts=sv, scan_faces=sf,
                                 sdf_resolution=16, device="cpu")
    cfg = tfit.FitConfig(num_iters=20, imsize=256.0, use_mesh=True,
                         displacement=True, mesh_loss_impl="sdf")
    init = tfit.FitParams.init(model, batch=1)
    prior = lambda p: p.new_zeros(p.shape[:-1])  # noqa: E731
    ref = tfit.fit(model, cfg, obs, init, prior)
    assert ref[2].shape == (1, 40) and ref[1]["displacement"].shape[0] == 1
    path = str(tmp_path / "d.ckpt")
    _assert_same(ck.fit_resumable(model, cfg, obs, init, prior, path,
                                  chunk_size=7), ref)
    assert torch.load(path + ".disp", weights_only=True)["step"] == 20
    # death in the displacement stage: the body stage is restored whole
    path = str(tmp_path / "d2.ckpt")
    problem = tfit.displacement_problem
    calls = []

    def dying_problem(*a, **kw):
        loss, opt, disp = problem(*a, **kw)

        def dying_loss(d):
            calls.append(1)
            if len(calls) == 10:
                raise _Died
            return loss(d)
        return dying_loss, opt, disp
    with monkeypatch.context() as m:
        m.setattr(ck.smplify, "displacement_problem", dying_problem)
        with pytest.raises(_Died):
            ck.fit_resumable(model, cfg, obs, init, prior, path,
                             chunk_size=7)
    assert torch.load(path + ".disp", weights_only=True)["step"] == 7
    _assert_same(ck.fit_resumable(model, cfg, obs, init, prior, path,
                                  chunk_size=7), ref)


def _jax_f64_side(path):
    """Subprocess body: JAX's ``fit_resumable`` in f64 on the first frame
    of the mask problem, saved with its inputs for the test process."""
    from bodyfitting_tpu.fitting import checkpointing as jck
    from bodyfitting_tpu.losses import silhouette as jsil

    jax.config.update("jax_enable_x64", True)
    model = jbm.synthetic_model("smplx", num_verts=400, seed=7)
    f64 = lambda t: jax.tree.map(  # noqa: E731
        lambda x: x.astype(jnp.float64)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, t)
    model64 = f64(model)
    obs = f64(_problem(model)[0])
    prior = synthetic_gmm_prior(dtype=jnp.float64)
    init = f64(jfit.FitParams.init(model))
    jsil.STAY_INSIDE = jsil.CONTOUR_MATCH = "xla"
    params, _, losses = jck.fit_resumable(
        model64, jfit.FitConfig(**_config()), obs, init, prior,
        checkpoint_path=path + ".ckpt", chunk_size=20)
    out = {"losses": np.asarray(losses)}
    for k, v in arrays_of(model64).items():
        if isinstance(v, np.ndarray):
            out[f"model.{k}"] = v
    for k, v in arrays_of(obs).items():
        if isinstance(v, np.ndarray):
            out[f"obs.{k}"] = v
    for k, v in arrays_of(prior).items():
        out[f"prior.{k}"] = v
    for k, v in arrays_of(params.body).items():
        out[f"params.{k}"] = v
    out["params.global_transl"] = np.asarray(params.global_transl)
    out["params.body_scale"] = np.asarray(params.body_scale)
    np.savez(path, **out)


def test_f64_fit_resumable_matches_jax(tmp_path):
    from bodyfitting_torch.convert import (
        body_model_from_numpy, gmm_prior_from_numpy, observations_from_numpy,
    )

    path = str(tmp_path / "jax_fit.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys; from tests.test_torch_checkpointing import "
         "_jax_f64_side; _jax_f64_side(sys.argv[1])", path],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    d = dict(np.load(path))
    jm = jbm.synthetic_model("smplx", num_verts=400, seed=7)
    static = {k: getattr(jm, k) for k in (
        "model_type", "parents", "neck_chain", "num_betas",
        "num_expressions", "num_hand_pca", "hand_use_pca", "flat_hand_mean",
        "use_face_contour")}
    fields = {k[6:]: v for k, v in d.items() if k.startswith("model.")}
    model = body_model_from_numpy({**fields, **static}, device="cpu")
    assert model.dtype == torch.float64
    prior = gmm_prior_from_numpy(
        *(d[f"prior.{k}"] for k in ("means", "precisions",
                                    "log_nll_weights", "mean_pose")),
        dtype=torch.float64, device="cpu")
    obs = observations_from_numpy(
        {k[4:]: v for k, v in d.items() if k.startswith("obs.")},
        device="cpu")
    init = tfit.FitParams.init(model, batch=1)
    params, _, losses = ck.fit_resumable(
        model, tfit.FitConfig(**_config()), obs, init, prior,
        checkpoint_path=str(tmp_path / "port.ckpt"), chunk_size=20)
    jl = d["losses"]
    assert losses.shape == (1, 60) and jl.shape == (60,)
    np.testing.assert_allclose(losses[0].numpy(), jl, rtol=1e-7)
    blocks = {k: getattr(params.body, k)[0].numpy()
              for k in tfit.bm.BODY_PARAM_FIELDS if f"params.{k}" in d}
    blocks["global_transl"] = params.global_transl[0].numpy()
    blocks["body_scale"] = params.body_scale[0].numpy()
    assert len(blocks) >= 5
    for k, v in blocks.items():
        ref = d[f"params.{k}"]
        scale = max(np.abs(ref).max(), 1e-3)
        np.testing.assert_allclose(v, ref, rtol=0, atol=1e-7 * scale,
                                   err_msg=k)
