"""The plain reference against the program's CPU path, in float64 on
seeded models at their published widths and small rigs: the body
forward, the mask observations, the staged objective before and after
the gate (keypoints, priors, silhouette, scan distance), the distance
volume, SMPL+D's objective and Adam's first steps.  Only these tests
import the program."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import fitlib, harness, traffic
from benchmark.drivers import mask_fit
from benchmark.reference import body
from benchmark.reference import losses as ref
from benchmark.reference import observations as robs
from benchmark.reference.volume import Volume

F64 = torch.float64
SMALL_MASK = dict(views=4, imsize=128, focal=225.0, dist=2.0, mask_views=2,
                  contour_points=64, scene_scale=0.3)
SMALL_SCAN = dict(views=4, imsize=128)
MASK_TRAFFIC = dict(frames_per_unit=2, pool_units=1, pose_scale=0.15,
                    betas_scale=0.5, orient_x=0.1, yaw=0.3, transl_scale=0.03,
                    gt_scale=1.15, keypoint_noise_px=1.0, splat_dilate=1,
                    init_noise=0.1)
SCAN_TRAFFIC = dict(pool_units=1, subdivisions=0, pose_scale=0.15,
                    betas_scale=0.5, orient_x=0.05, yaw=0.3,
                    keypoint_noise_px=1.0, init_noise=0.1)


def _cfg(name, rig, **fit):
    cfg = harness.load_json(harness.HERE, "configs", name + ".json")
    cfg["rig"] = dict(cfg["rig"], **rig)
    cfg["fit"] = dict(cfg["fit"], **fit)
    return cfg


def _to64(obj):
    """Every floating tensor of a (nested) dataclass as float64."""
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            v = _to64(v)
        elif torch.is_tensor(v) and v.is_floating_point():
            v = v.double()
        kw[f.name] = v
    return type(obj)(**kw)


@pytest.fixture(scope="module")
def mask_case(tmp_path_factory):
    cfg = _cfg("smplx_genebody", SMALL_MASK, imsize=128.0, num_iters=9)
    paths = fitlib.write_assets(cfg, 11, str(tmp_path_factory.mktemp("mx")))
    model, prior = fitlib.load_program(cfg, paths, "cpu", dtype=F64)
    rmodel = body.load(paths["model"], "smplx")
    pool = traffic.mask_frames(rmodel, cfg, MASK_TRAFFIC, 11)
    state = dict(cfg=cfg, pool=pool, device="cpu", n=2, units=1,
                 views=[[dict(pose=k[:25], hand_left=k[25:46],
                              hand_right=k[46:67],
                              face=k[mask_fit._FACE_ORDER])
                         for k in fr["keypoints"]] for fr in pool["frames"]],
                 ref_model=rmodel)
    obs = mask_fit.observations(state, [0, 1])
    return dict(cfg=cfg, paths=paths, model=model, prior=prior,
                rmodel=rmodel, pool=pool, state=state, obs=obs)


def _params(rng, model, B, kind):
    nb = 3 * (23 if kind == "smpl" else 21)
    sizes = dict(betas=10, global_orient=3, body_pose=nb,
                 expression=10 if kind == "smplx" else 0, jaw_pose=3,
                 leye_pose=3, reye_pose=3, left_hand_pose=6,
                 right_hand_pose=6, global_transl=3, body_scale=1)
    ts = [torch.as_tensor(rng.normal(scale=0.2, size=(B, sizes[f])),
                          dtype=F64) for f in ref.PARAM_FIELDS]
    ts[-1] = ts[-1] + 1.0
    return ts


@pytest.mark.parametrize("kind", ["smplx", "smpl"])
def test_forward_matches_program(tmp_path, kind):
    from bodyfitting_torch.models import body_model as bm

    name = "smplx_genebody" if kind == "smplx" else "smpl_renderpeople"
    cfg = _cfg(name, {})
    paths = fitlib.write_assets(cfg, 5, str(tmp_path))
    model, _ = fitlib.load_program(cfg, paths, "cpu", dtype=F64)
    rmodel = body.load(paths["model"], kind)
    ts = _params(np.random.default_rng(1), model, 2, kind)
    p = dict(zip(ref.PARAM_FIELDS, ts))
    out = bm.forward(model, bm.BodyParams(**{k: p[k]
                                             for k in bm.BODY_PARAM_FIELDS}))
    v, j = body.forward(rmodel, p)
    np.testing.assert_allclose(out.vertices.numpy(), v.numpy(), atol=1e-12)
    np.testing.assert_allclose(out.joints[:, :j.shape[1]].numpy(), j.numpy(),
                               atol=1e-12)


def test_observations_match_program(mask_case):
    for f, o in enumerate(mask_case["obs"]):
        c, w, k, org = robs.mask_views(
            mask_case["pool"]["frames"][f]["masks"], 64,
            mask_case["pool"]["crop_hw"])
        np.testing.assert_array_equal(o.contours[0].numpy(), c)
        np.testing.assert_array_equal(o.contour_valid[0].numpy(), w)
        np.testing.assert_array_equal(o.mask_crops[0].numpy(), k)
        np.testing.assert_array_equal(o.mask_crop_origins[0].numpy(), org)
        np.testing.assert_array_equal(
            o.keypoints[0].numpy(),
            mask_case["pool"]["frames"][f]["keypoints"])


@pytest.mark.parametrize("step", [0, 8])
def test_mask_objective_matches_program(mask_case, step):
    from bodyfitting_torch.fitting import smplify

    cfg = fitlib.objective(mask_case["cfg"])
    config = fitlib.fit_config(mask_case["cfg"])
    obs = _to64(smplify.concat_frames(mask_case["obs"]))
    models = smplify.loss_models(mask_case["model"], config)
    rmodel = body.load(mask_case["paths"]["model"], "smplx")
    ts = fitlib.ref_init(rmodel, [fr["init"] for fr in
                                  mask_case["pool"]["frames"]], F64, "cpu")
    prog, _ = smplify.fit_loss(
        models[0], config, smplify.FitParams.from_tensors(ts),
        smplify.step_observations(obs), step, mask_case["prior"],
        joints_model=models[1], mask_vertex_rows=models[2])
    state = dict(mask_case["state"], ref_model=rmodel)
    robs_, _ = mask_fit.reference_obs(state, [0, 1], F64, "cpu")
    # the program's cameras and scale are float32: the same inputs
    robs_.update(w2c=obs.w2cs, mask_w2c=obs.mask_w2cs,
                 constant_scale=obs.constant_scale)
    want = ref.fit_loss(cfg, rmodel, robs_, dict(zip(ref.PARAM_FIELDS, ts)),
                        step, ref.GMMPrior(mask_case["paths"]["prior"]))
    np.testing.assert_allclose(prog.numpy(), want.numpy(), rtol=1e-9)


def test_adam_steps_match_program(mask_case):
    from bodyfitting_torch.fitting import smplify

    cfg = fitlib.objective(mask_case["cfg"])
    config = fitlib.fit_config(mask_case["cfg"])
    obs = _to64(smplify.concat_frames(mask_case["obs"]))
    rmodel = body.load(mask_case["paths"]["model"], "smplx")
    ts = fitlib.ref_init(rmodel, [fr["init"] for fr in
                                  mask_case["pool"]["frames"]], F64, "cpu")
    params = smplify.FitParams.from_tensors([t.clone() for t in ts])
    opt = smplify.make_optimizer(config, params)
    step_fn = smplify.make_step_fn(mask_case["model"], config, obs,
                                   mask_case["prior"], opt)
    prog = torch.stack([step_fn(i) for i in range(4)], 1)
    state = dict(mask_case["state"], ref_model=rmodel)
    robs_, _ = mask_fit.reference_obs(state, [0, 1], F64, "cpu")
    # the program's cameras and scale are float32: the same inputs
    robs_.update(w2c=obs.w2cs, mask_w2c=obs.mask_w2cs,
                 constant_scale=obs.constant_scale)
    prior = ref.GMMPrior(mask_case["paths"]["prior"])
    want, _ = ref.follow(
        lambda i, x: ref.fit_loss(cfg, rmodel, robs_,
                                  dict(zip(ref.PARAM_FIELDS, x)), i, prior),
        ts, ref.body_lrs(cfg), 4)
    np.testing.assert_allclose(prog.numpy(), want.numpy(), rtol=1e-9)


@pytest.fixture(scope="module")
def scan_case(tmp_path_factory):
    from bodyfitting_torch.ops import sdf

    cfg = _cfg("smpl_renderpeople", SMALL_SCAN, imsize=128.0, num_iters=9,
               sdf_resolution=12)
    paths = fitlib.write_assets(cfg, 13, str(tmp_path_factory.mktemp("sc")))
    model, prior = fitlib.load_program(cfg, paths, "cpu", dtype=F64)
    rmodel = body.load(paths["model"], "smpl")
    s = traffic.scans(rmodel, cfg, SCAN_TRAFFIC, 13)[0]
    sv = torch.as_tensor(s["scan_verts"], dtype=F64)
    sf = torch.as_tensor(s["scan_faces"])
    vol = sdf.build_distance_volume(sv, sf, resolution=12)
    return dict(cfg=cfg, paths=paths, model=model, prior=prior, scan=s,
                sv=sv, sf=sf, vol=vol, rvol=Volume(sv, sf, 12))


def test_volume_matches_program(scan_case):
    R = 12
    cells = torch.arange(R ** 3)
    d, f = scan_case["rvol"].cells(cells)
    np.testing.assert_allclose(scan_case["vol"].dist.reshape(-1).numpy(),
                               d.numpy(), atol=1e-12)
    np.testing.assert_array_equal(
        scan_case["vol"].face_idx.reshape(-1).numpy(), f.numpy())


def _scan_obs(case):
    from bodyfitting_torch.fitting import body_fitting as bf
    from bodyfitting_torch.fitting import smplify
    from bodyfitting_torch.ops import sdf

    s = case["scan"]
    obs = bf.build_observations(
        s["c2ws"], s["Ks"], [dict(pose=k) for k in s["keypoints"]],
        use_hand_face=False, scan_verts=s["scan_verts"],
        scan_faces=s["scan_faces"], build_sdf=False, device="cpu")
    v = case["vol"]
    obs = dataclasses.replace(_to64(obs), scan_volume=sdf.DistanceVolume(
        dist=v.dist[None], face_idx=v.face_idx[None], origin=v.origin[None],
        spacing=v.spacing.reshape(1)))
    return obs, smplify


@pytest.mark.parametrize("step", [0, 8])
def test_scan_objective_matches_program(scan_case, step):
    obs, smplify = _scan_obs(scan_case)
    config = fitlib.fit_config(scan_case["cfg"])
    models = smplify.loss_models(scan_case["model"], config)
    rmodel = body.load(scan_case["paths"]["model"], "smpl")
    ts = _params(np.random.default_rng(2), rmodel, 1, "smpl")
    prog, _ = smplify.fit_loss(models[0], config,
                               smplify.FitParams.from_tensors(ts), obs, step,
                               scan_case["prior"], joints_model=models[1])
    s, sv = scan_case["scan"], scan_case["sv"]
    height = sv[:, 1].max() - sv[:, 1].min()
    w2c = np.linalg.inv(s["c2ws"].astype(np.float64))
    robs_ = dict(w2c=torch.as_tensor(w2c[None]),
                 K=torch.as_tensor(s["Ks"][None], dtype=F64),
                 keypoints=torch.as_tensor(s["keypoints"][None], dtype=F64),
                 view_mask=torch.ones(1, 4, dtype=F64), num_views=4.0,
                 constant_scale=obs.constant_scale, scan_height=height)
    want = ref.fit_loss(fitlib.objective(scan_case["cfg"]), rmodel, robs_,
                        dict(zip(ref.PARAM_FIELDS, ts)), step,
                        ref.GMMPrior(scan_case["paths"]["prior"]),
                        scan_case["rvol"])
    np.testing.assert_allclose(prog.numpy(), want.numpy(), rtol=1e-9)


def test_displacement_matches_program(scan_case):
    obs, smplify = _scan_obs(scan_case)
    config = fitlib.fit_config(scan_case["cfg"])
    rng = np.random.default_rng(3)
    bverts = scan_case["model"].v_template[None] + torch.as_tensor(
        rng.normal(scale=0.01, size=(1, 6890, 3)))
    loss_fn, opt, disp = smplify.displacement_problem(
        scan_case["model"], config, obs, bverts)
    prog = []
    for _ in range(4):
        disp.requires_grad_(True)
        loss = loss_fn(disp)
        (g,) = torch.autograd.grad(loss.sum(), [disp])
        disp.requires_grad_(False)
        opt.step([g])
        prog.append(loss.detach())
    sv, sf = scan_case["sv"], scan_case["sf"]
    tri = sv[sf]
    fn = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0],
                            dim=-1)
    faces = torch.as_tensor(np.load(scan_case["paths"]["model"])["f"])
    want, _ = ref.follow(
        lambda i, x: ref.displacement_loss(
            scan_case["rvol"], fn, obs.constant_scale[0], bverts[0], x[0],
            faces)[None], [torch.zeros_like(bverts[0])], [5e-2], 4)
    np.testing.assert_allclose(torch.stack(prog, 1).numpy(), want.numpy(),
                               rtol=1e-9)
