"""A batch of two scans through the port's ``fit_frames_batched`` against
JAX's (a ``vmap`` of the one-scan fit), in f64 on the CPU.

The scans are ``chip_smoke.make_scan_problem``'s (``test_torch_scan_fit``'s
small problem: a 92-vertex synthetic SMPL, its posed surface subdivided
once, 4 ring views at 256²) and the same scan turned 90° about the
vertical axis and moved 0.1 m, with its cameras moved alike, so both
frames share the keypoints and the topology.  30 body iterations (the
point-to-scan term on after step 10) and 30 displacement iterations on
each route: each frame has its own scan, height, scale prior and volume.
The JAX side runs in a subprocess with ``jax_enable_x64``.  Tolerance, as
``test_torch_scan_fit.py``: 1e-7 relative on the loss traces and 1e-7 of
each block's scale on parameters, vertices and displacements.
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
from bodyfitting_torch.convert import observations_from_numpy
from bodyfitting_torch.fitting import body_fitting as tbf
from bodyfitting_torch.fitting import smplify as tfit
from chip_smoke import turned_scan
from tests.test_torch_scan_fit import (
    _STATIC, IMPLS, ITERS, SDF_RES, _config, _jax_model, _port_side,
    _scan_problem,
)
from tests.torch_port_util import arrays_of, torch_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The fits' tensors are tiny: one intra-op thread runs them as fast
    alone and keeps them fast beside the suite's other workers (eight
    threads a worker oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_f64_side(path):
    """Subprocess body: JAX's batched f64 scan fits on both routes."""
    jax.config.update("jax_enable_x64", True)
    model = _jax_model()
    c2ws, Ks, kps, sv, sf = _scan_problem(model)
    c2ws1, sv1 = turned_scan(c2ws, sv)
    f64 = lambda t: jax.tree.map(  # noqa: E731
        lambda x: x.astype(jnp.float64)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, t)
    obs, inits = [], []
    for cams, verts in ((c2ws, sv), (c2ws1, sv1)):
        o = jbf.build_observations(cams, Ks, kps, use_hand_face=False,
                                   scan_verts=verts, scan_faces=sf,
                                   sdf_resolution=SDF_RES)
        betas, poses = jbf.hmr_init(None, cams[0])
        obs.append(f64(o))
        inits.append(f64(jbf.init_params_from_hmr(model, betas, poses)))
    model64 = f64(model)
    prior = synthetic_gmm_prior(dtype=jnp.float64)
    out = {}
    for b, o in enumerate(obs):
        for k, v in arrays_of(o).items():
            if isinstance(v, np.ndarray):
                out[f"obs{b}.{k}"] = v
        for k, v in arrays_of(o.scan_volume).items():
            out[f"vol{b}.{k}"] = v
        out[f"c2w{b}"] = (c2ws, c2ws1)[b][0]
    # what test_torch_scan_fit._port_side reads: model, prior, frame 0
    for k, v in arrays_of(model64).items():
        if isinstance(v, np.ndarray):
            out[f"model.{k}"] = v
    for k, v in arrays_of(prior).items():
        out[f"prior.{k}"] = v
    for k in list(out):
        if k.startswith(("obs0.", "vol0.")):
            out[k[:3] + k[4:]] = out[k]
    out["poses"] = jbf.hmr_init(None, c2ws[0])[1]
    out["c2w0"] = c2ws[0]
    out["static"] = np.asarray(json.dumps(
        {k: getattr(model, k) for k in _STATIC}))
    for impl in IMPLS:
        cfg = jfit.FitConfig(**_config(impl))
        params, result, losses = jbf.fit_frames_batched(model64, cfg, obs,
                                                        inits, prior)
        out[f"{impl}.losses"] = np.asarray(losses)
        for key in ("vertices", "displacement"):
            out[f"{impl}.{key}"] = np.asarray(result[key])
        out[f"{impl}.global_transl"] = np.asarray(params.global_transl)
        out[f"{impl}.body_pose"] = np.asarray(params.body.body_pose)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def jax_batch(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("scan_batch") / "jax_batch.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys; from tests.test_torch_scan_batch import _jax_f64_side; "
         "_jax_f64_side(sys.argv[1])", path],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=900,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(path))


def _frame(d, b):
    fields = {k.split(".", 1)[1]: v for k, v in d.items()
              if k.startswith(f"obs{b}.")}
    fields["scan_volume"] = {k.split(".", 1)[1]: v for k, v in d.items()
                             if k.startswith(f"vol{b}.")}
    return observations_from_numpy(fields, device="cpu")


def _close(got, ref, what):
    np.testing.assert_allclose(
        got, ref, rtol=0, atol=1e-7 * float(np.abs(ref).max(initial=1.0)),
        err_msg=what)


@pytest.mark.parametrize("impl", IMPLS)
def test_f64_batch_of_two_scans_matches_jax(jax_batch, impl):
    d = jax_batch
    model, prior, _, _ = _port_side(d)
    obs = [_frame(d, b) for b in (0, 1)]
    inits = [tbf.init_params_from_hmr(model, *tbf.hmr_init(None, d[f"c2w{b}"]))
             for b in (0, 1)]
    # each frame reads its own volume
    assert not torch.equal(obs[0].scan_volume.origin,
                           obs[1].scan_volume.origin)
    cfg = tfit.FitConfig(**_config(impl))
    params, result, losses = tbf.fit_frames_batched(model, cfg, obs, inits,
                                                    prior)
    jl = d[f"{impl}.losses"]
    assert losses.shape == jl.shape == (2, 2 * ITERS)
    np.testing.assert_allclose(losses.numpy(), jl, rtol=1e-7)
    assert result["displacement"].shape == (2, model.num_verts, 3)
    for key in ("vertices", "displacement"):
        _close(result[key].numpy(), d[f"{impl}.{key}"], key)
    _close(params.global_transl.numpy(), d[f"{impl}.global_transl"],
           "global_transl")
    _close(params.body.body_pose.numpy(), d[f"{impl}.body_pose"],
           "body_pose")
    # frame 0 of the batch is the one-scan fit of frame 0, up to the
    # rounding of batched reductions (f64)
    p1, r1, l1 = tbf.fit_scan(model, cfg, obs[0], inits[0], prior)
    np.testing.assert_allclose(losses[0].numpy(), l1.numpy(), rtol=1e-9)
    _close(result["vertices"][0].numpy(), r1["vertices"].numpy(),
           "batch frame 0 vs one scan")


def test_scans_of_different_shapes_do_not_batch():
    model = _jax_model()
    tm = torch_model(model)
    c2ws, Ks, kps, sv, sf = _scan_problem(model)
    a = tbf.build_observations(c2ws, Ks, kps, use_hand_face=False,
                               scan_verts=sv, scan_faces=sf, build_sdf=False,
                               device="cpu")
    b = tbf.build_observations(c2ws, Ks, kps, use_hand_face=False,
                               scan_verts=sv, scan_faces=sf[:-2],
                               build_sdf=False, device="cpu")
    init = tfit.FitParams.init(tm)
    cfg = tfit.FitConfig(**dict(_config("exact"), num_iters=3))
    with pytest.raises(ValueError, match="scan_faces has shapes"):
        tbf.fit_frames_batched(tm, cfg, [a, b], [init, init],
                               lambda p: p.new_zeros(p.shape[:-1]))
    c = dataclasses.replace(
        a, scan_verts=torch.cat([a.scan_verts, a.scan_verts[:, :1]], 1))
    with pytest.raises(ValueError, match="different shapes"):
        tfit.concat_frames([a, c])
