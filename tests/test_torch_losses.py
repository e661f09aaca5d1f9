"""The port's losses against the JAX package's, in f32 on the CPU.

Tolerances:
  * keypoint + prior objective: rtol 1e-5 on values, 1e-4 of the largest
    gradient entry on gradients (f32, other summation orders);
  * silhouette vs JAX's XLA route: rtol 1e-5 on values, 1e-5 of the
    largest gradient entry (same f32 arithmetic; no vertex projects onto
    a hinge kink in these inputs, which the test checks);
  * silhouette vs JAX's Pallas route (interpret mode): rtol 2e-3 on
    values, 2e-2 of the largest gradient entry, because that kernel rounds
    its hinge weights to bf16 (8 bits of mantissa) and the port does not.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bodyfitting_tpu.fitting import smplify as jfit
from bodyfitting_tpu.losses import silhouette as jsil
from bodyfitting_tpu.losses.priors import synthetic_gmm_prior
from bodyfitting_tpu.models import body_model as jbm
from bodyfitting_torch.fitting import smplify as tfit
from bodyfitting_torch.losses import silhouette as tsil
from tests.torch_port_util import (
    torch_model, torch_obs, torch_params, torch_prior,
)

H = 96


def _masks():
    masks = np.zeros((2, H, H), np.float32)
    masks[0, 20:80, 30:62] = 1.0
    masks[1, 12:70, 22:60] = 1.0
    masks[1, 40:60, 60:75] = 1.0
    return masks


def _cameras(n):
    w2c = np.eye(4, dtype=np.float32)
    w2c[2, 3] = 2.0
    K = np.array([[100.0, 0, H / 2], [0, 100.0, H / 2], [0, 0, 1]],
                 np.float32)
    return (np.broadcast_to(w2c, (n, 4, 4)).copy(),
            np.broadcast_to(K, (n, 3, 3)).copy())


def _mask_inputs(masks):
    contours, valid = jsil.extract_contours(list(masks))
    rc, rw = jsil.resample_contours(contours, valid, 64)
    crops, origins, _ = jsil.compute_mask_crops(list(masks))
    return rc, rw, crops, origins


def _jax_sil(verts, impl, crop=True):
    masks = _masks()
    rc, rw, crops, origins = _mask_inputs(masks)
    w2cs, Ks = _cameras(2)
    kw = dict(imsize=float(H), vertex_stride=1, full_hw=(H, H))
    if crop:
        kw.update(mask_crops=jnp.asarray(crops),
                  mask_crop_origins=jnp.asarray(origins))
    old = jsil.STAY_INSIDE, jsil.CONTOUR_MATCH
    jsil.STAY_INSIDE = jsil.CONTOUR_MATCH = impl
    try:
        return jax.value_and_grad(lambda v: jsil.silhouette_loss(
            jnp.asarray(rc), jnp.asarray(rw),
            None if crop else jnp.asarray(masks),
            jnp.asarray(w2cs), jnp.asarray(Ks), v, **kw,
        ))(jnp.asarray(verts))
    finally:
        jsil.STAY_INSIDE, jsil.CONTOUR_MATCH = old


def _torch_sil(verts, crop=True, pad_view=False):
    """Port's loss and vertex gradient for frames ``verts [B, V, 3]``."""
    masks = _masks()
    rc, rw, crops, origins = _mask_inputs(masks)
    w2cs, Ks = _cameras(2)
    vvalid = np.ones(2, np.float32)
    if pad_view:
        def pad(a, fill):
            return np.concatenate([a, np.full((1,) + a.shape[1:], fill,
                                              np.float32)])
        rc, rw, crops = pad(rc, 0.0), pad(rw, 0.0), pad(crops, 1.0)
        origins, vvalid, masks = pad(origins, 0.0), pad(vvalid, 0.0), \
            pad(masks, 1.0)
        w2cs = np.concatenate([w2cs, np.eye(4, dtype=np.float32)[None]])
        Ks = np.concatenate([Ks, np.eye(3, dtype=np.float32)[None]])
    B = verts.shape[0]

    def t(a):
        return torch.from_numpy(np.broadcast_to(a, (B,) + a.shape).copy())

    v = torch.from_numpy(verts).requires_grad_(True)
    kw = dict(imsize=float(H), vertex_stride=1, full_hw=(H, H))
    if crop:
        kw.update(mask_crops=t(crops), mask_crop_origins=t(origins),
                  mask_view_valid=t(vvalid))
    loss = tsil.silhouette_loss(t(rc), t(rw), None if crop else t(masks),
                                t(w2cs), t(Ks), v, **kw)
    (g,) = torch.autograd.grad(loss.sum(), v)
    return loss.detach().numpy(), g.numpy()


def _verts(rng, B=2, V=300):
    return (rng.normal(size=(B, V, 3)) * 0.5).astype(np.float32)


def _off_kinks(verts):
    """No vertex projects within 1e-4 px of an integer pixel-grid
    coordinate (where the hinge derivatives have kinks)."""
    w2cs, Ks = _cameras(1)
    cam = verts @ w2cs[0, :3, :3].T + w2cs[0, :3, 3]
    uv = cam @ Ks[0].T
    xyhat = uv[..., :2] / uv[..., 2:3] * ((H - 1) / H)
    return np.abs(xyhat - np.round(xyhat)).min() > 1e-4


@pytest.mark.parametrize("crop", [True, False])
def test_silhouette_matches_jax_xla(rng, crop):
    verts = _verts(rng)
    assert _off_kinks(verts)
    loss, grad = _torch_sil(verts, crop=crop)
    for b in range(2):
        jl, jg = _jax_sil(verts[b], "xla", crop=crop)
        np.testing.assert_allclose(loss[b], float(jl), rtol=1e-5)
        np.testing.assert_allclose(grad[b], np.asarray(jg),
                                   atol=1e-5 * np.abs(jg).max())


def test_silhouette_crop_matches_jax_pallas(rng):
    verts = _verts(rng, B=1)
    loss, grad = _torch_sil(verts)
    jl, jg = _jax_sil(verts[0], "pallas")
    np.testing.assert_allclose(loss[0], float(jl), rtol=2e-3)
    np.testing.assert_allclose(grad[0], np.asarray(jg),
                               atol=2e-2 * np.abs(jg).max())


def test_silhouette_padded_view_inert_and_crop_equals_full(rng):
    verts = _verts(rng)
    base, gbase = _torch_sil(verts)
    padded, gpad = _torch_sil(verts, pad_view=True)
    np.testing.assert_allclose(padded, base, rtol=1e-6)
    np.testing.assert_allclose(gpad, gbase, atol=1e-6 * np.abs(gbase).max())
    full, gfull = _torch_sil(verts, crop=False)
    fullpad, _ = _torch_sil(verts, crop=False, pad_view=True)
    np.testing.assert_allclose(base, full, rtol=1e-6)
    np.testing.assert_allclose(fullpad, full, rtol=1e-6)
    np.testing.assert_allclose(gbase, gfull, atol=2e-5 * np.abs(gfull).max())


def _keypoint_problem(rng):
    model = jbm.synthetic_model("smplx", num_verts=320, seed=3)
    prior = synthetic_gmm_prior()
    w2cs, Ks = _cameras(3)
    w2cs[1, :3, :3] = np.array([[0, 0, 1], [0, 1, 0], [-1, 0, 0]])
    kps = rng.uniform(20, 76, size=(3, 135, 3)).astype(np.float32)
    obs = jfit.Observations(
        w2cs=jnp.asarray(w2cs), Ks=jnp.asarray(Ks), keypoints=jnp.asarray(kps),
        view_mask=jnp.asarray([1.0, 1.0, 0.0]),
        constant_scale=jnp.asarray(0.3, jnp.float32),
        num_views_used=jnp.asarray(2.0, jnp.float32),
    )
    init = jfit.FitParams.init(model)
    body = dataclasses.replace(
        init.body,
        body_pose=jnp.asarray(rng.normal(scale=0.2, size=63), jnp.float32),
        betas=jnp.asarray(rng.normal(scale=0.3, size=10), jnp.float32),
        left_hand_pose=jnp.asarray(rng.normal(scale=0.3, size=6),
                                   jnp.float32),
    )
    params = dataclasses.replace(
        init, body=body, global_transl=jnp.asarray([0.02, -0.01, 0.1]),
        body_scale=jnp.asarray([1.1]),
    )
    return model, prior, obs, params


@pytest.mark.parametrize("view_chunk", [0, 1])
def test_keypoint_and_prior_loss_matches_jax(rng, view_chunk):
    model, prior, obs, params = _keypoint_problem(rng)
    cfg = jfit.FitConfig(imsize=float(H), view_chunk=view_chunk)
    (jl, jterms), jg = jax.jit(jax.value_and_grad(
        lambda p: jfit.fit_loss(model, cfg, p, obs, jnp.asarray(0), prior),
        has_aux=True,
    ))(params)

    tcfg = tfit.FitConfig(imsize=float(H), view_chunk=view_chunk)
    tp = torch_params(params)
    leaves = [t.requires_grad_(True) for t in tp.tensors()]
    tl, tterms = tfit.fit_loss(torch_model(model), tcfg,
                               tfit.FitParams.from_tensors(leaves),
                               torch_obs(obs), 0, torch_prior(prior))
    grads = torch.autograd.grad(tl.sum(), leaves, allow_unused=True)
    np.testing.assert_allclose(float(tl[0].detach()), float(jl), rtol=1e-5)
    for k in ("body_loss", "hand_loss", "face_loss", "pose_prior_loss",
              "angle_prior_loss", "shape_prior_loss"):
        np.testing.assert_allclose(float(tterms[k][0]), float(jterms[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    jleaves = [getattr(jg.body, f) for f in
               ("betas", "global_orient", "body_pose", "expression",
                "jaw_pose", "leye_pose", "reye_pose", "left_hand_pose",
                "right_hand_pose")] + [jg.global_transl, jg.body_scale]
    top = max(float(jnp.abs(x).max()) for x in jleaves)
    for g, r in zip(grads, jleaves):
        g = np.zeros(r.shape) if g is None else g[0].numpy()
        np.testing.assert_allclose(g, np.asarray(r), atol=1e-4 * top)


def _contour_cases():
    yy, xx = np.mgrid[:80, :96]
    rect = np.zeros((80, 96), np.float32)
    rect[10:50, 20:70] = 1.0
    ellipse = ((((xx - 50) / 33.0) ** 2 + ((yy - 38) / 21.0) ** 2) < 1)
    blobs = np.zeros((80, 96), np.float32)
    blobs[5:20, 5:15] = 255.0
    blobs[30:75, 40:90] = 255.0
    border = np.zeros((80, 96), np.float32)
    border[0:60, 50:96] = 1.0
    return [rect, ellipse.astype(np.float32), blobs, border]


def test_extract_contours_matches_cv2():
    pytest.importorskip("cv2")
    masks = _contour_cases()
    jc, jv = jsil.extract_contours(masks)
    tc, tv = tsil.extract_contours(masks)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tv, jv)
    jc, jv = jsil.extract_contours(masks, pad_to=100)
    tc, tv = tsil.extract_contours(masks, pad_to=100)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tv, jv)


def test_mask_prep_matches_jax():
    masks = _contour_cases()
    jc, jv = jsil.extract_contours(masks) if _has_cv2() else \
        tsil.extract_contours(masks)
    for a, b in zip(tsil.resample_contours(jc, jv, 64),
                    jsil.resample_contours(jc, jv, 64)):
        np.testing.assert_array_equal(a, b)
    for crop_hw in (None, (80, 96)):
        t_out = tsil.compute_mask_crops(masks, crop_hw=crop_hw)
        j_out = jsil.compute_mask_crops(masks, crop_hw=crop_hw)
        np.testing.assert_array_equal(t_out[0], j_out[0])
        np.testing.assert_array_equal(t_out[1], j_out[1])
        assert t_out[2] == j_out[2]
    x = np.array([[0.0, 0.0], [-0.5, 3.0], [95.5, 10.0], [40.0, 79.6]],
                 np.float32)
    np.testing.assert_allclose(
        tsil.coverage_closed_form(torch.from_numpy(x), (80, 96)).numpy(),
        np.asarray(jsil.coverage_closed_form(jnp.asarray(x), (80, 96))),
        atol=1e-7)


def _has_cv2():
    try:
        import cv2  # noqa: F401
    except ImportError:
        return False
    return True


def test_gmm_prior_from_pickle_and_l2_prior_match_jax(rng, tmp_path):
    import pickle

    from bodyfitting_tpu.losses import priors as jpri
    from bodyfitting_torch.losses import priors as tpri

    A = rng.normal(size=(3, 69, 69)) * 0.05
    gmm = dict(means=rng.normal(scale=0.3, size=(3, 69)),
               covars=A @ A.transpose(0, 2, 1) + 0.25 * np.eye(69),
               weights=np.array([0.2, 0.5, 0.3]))
    path = str(tmp_path / "gmm.pkl")
    with open(path, "wb") as f:
        pickle.dump(gmm, f)
    jp = jpri.load_gmm_prior(path)
    tp = tpri.load_gmm_prior(path, device="cpu")
    for name in ("means", "precisions", "log_nll_weights", "mean_pose"):
        np.testing.assert_allclose(getattr(tp, name).numpy(),
                                   np.asarray(getattr(jp, name)), rtol=1e-6,
                                   err_msg=name)
    pose = rng.normal(scale=0.3, size=(4, 69)).astype(np.float32)
    np.testing.assert_allclose(tp(torch.from_numpy(pose)).numpy(),
                               np.asarray(jp(jnp.asarray(pose))), rtol=1e-5)
    # the port's l2_prior is per frame: one JAX l2_prior per row
    np.testing.assert_allclose(
        tpri.l2_prior(torch.from_numpy(pose)).numpy(),
        [float(jpri.l2_prior(jnp.asarray(p))) for p in pose], rtol=1e-6)
