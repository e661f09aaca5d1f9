"""A scan fit: a unit is one scan that the program turns into
observations (``build_observations`` with the scan: keypoints and the
scan's distance volume) and fits (``fit_scan(FitConfig(use_mesh=True,
displacement=True))``: the staged SMPLify with the point-to-scan term
after the gate, then SMPL+D); the fitted vertices, displacements,
parameters and loss trace are read back to the host.

``correct`` holds what the window produced to the plain reference:
every unit's distance volume at each cell the checks read, the vertices
at its fitted parameters, its body fit's loss trace through the gate
and three steps past it (keypoints, priors, Adam, then the scan distance
through the volume), and the first steps of its SMPL+D fit from the
fitted body (scan distance, normals, smoothness, Adam: the loss at the
start and after one step), each followed step by step by the reference
from the same start.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from benchmark import counts, fitlib, harness, traffic
from benchmark.reference import body
from benchmark.reference import losses as ref
from benchmark.reference.volume import Volume

LIMITS = dict(volume=1e-3, verts=1e-5, steps=2e-4, disp_steps=1e-3)
PAST_GATE = 3       # body steps the reference follows past the gate
# SMPL+D losses it follows: at the start and after the first step.  Past
# that, Adam's sign-like first steps (5 cm a coordinate) move vertices
# whose gradient is nought to rounding by round-off alone.
FOLLOW = 2
PERSON_HEIGHT = 1.7     # the RenderPeople fit's constant scale: height / 1.7


def setup(cell, seed, device, workdir, spans):
    cfg, t = cell["config"], cell["work"]["traffic"]
    paths = spans("assets", fitlib.write_assets, cfg, seed, workdir)
    model, prior = spans("load", fitlib.load_program, cfg, paths, device)
    rmodel = body.load(paths["model"], "smpl")
    pool = spans("inputs", traffic.scans, rmodel, cfg, t, seed)
    state = dict(cfg=cfg, traffic=t, device=device, model=model, prior=prior,
                 paths=paths, pool=pool, config=fitlib.fit_config(cfg),
                 units=t["pool_units"])
    spans("warmup", run, state, 0, fitlib.fit_config(cfg, num_iters=6))
    return state


def observations(state, k):
    from bodyfitting_torch.fitting import body_fitting as bf

    s = state["pool"][k]
    return bf.build_observations(
        s["c2ws"], s["Ks"], [dict(pose=kp) for kp in s["keypoints"]],
        use_hand_face=False, scan_verts=s["scan_verts"],
        scan_faces=s["scan_faces"],
        sdf_resolution=state["cfg"]["fit"]["sdf_resolution"],
        device=state["device"])


def _fit(state, obs, k, config):
    from bodyfitting_torch.fitting import body_fitting as bf

    init = fitlib.program_init(state["model"], [state["pool"][k]["init"]],
                               state["device"])[0]
    return bf.fit_scan(state["model"], config, obs, init, state["prior"])


def _readback(params, result, losses):
    return dict(vertices=result["vertices"][None].cpu(),
                displacement=result["displacement"][None].cpu(),
                params=fitlib.params_to_host(params),
                losses=losses[None].cpu())


def run(state, i, config=None, around_obs=contextlib.nullcontext,
        around_fit=contextlib.nullcontext):
    """Unit ``i``: its scan's observations (the volume), the fit and the
    read back, each in a span; ``around_obs`` and ``around_fit`` wrap the
    first two (a traced run's profilers)."""
    config = config or state["config"]
    spans = harness.Spans(state["device"])
    k = i % state["units"]
    with around_obs():
        obs = spans("observations", observations, state, k)
    with around_fit():
        params, result, losses = spans("fit", _fit, state, obs, k, config)
    out = spans("readback", _readback, params, result, losses)
    work = dict(state["cfg"], fit=dict(state["cfg"]["fit"],
                                       num_iters=config.num_iters))
    return dict(scan=k, obs=obs, out=out, spans=spans.items,
                steps=config.num_iters, opt_steps=2 * config.num_iters,
                ops=counts.scan_fit_ops(work))


def unit(state, i):
    return run(state, i)


def traced_unit(state, i, trace_dir):
    return fitlib.traced(run, state, i, trace_dir)


def release(records):
    """The program's distance volumes as host arrays; the device copies
    freed."""
    for r in records:
        vol = r.pop("obs").scan_volume
        r["volume_host"] = vol.dist[0].cpu()


def check(state, records, dtype=torch.float64):
    """The compared numbers ``[(name, value, limit)]``, each the worst
    over every unit of the window."""
    device = state["device"]
    model = body.load(state["paths"]["model"], "smpl", dtype=dtype,
                      device=device)
    prior = ref.GMMPrior(state["paths"]["prior"], dtype=dtype, device=device)
    cfg = fitlib.objective(state["cfg"])
    R = state["cfg"]["fit"]["sdf_resolution"]
    worst = dict(volume=0.0, verts=0.0, steps=0.0, disp_steps=0.0)
    for r in records:
        s, out = state["pool"][r["scan"]], r["out"]

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        sv = t(s["scan_verts"])
        faces = torch.as_tensor(s["scan_faces"], device=device)
        vol = Volume(sv, faces, R)
        height = sv[:, 1].max() - sv[:, 1].min()
        cscale = height / PERSON_HEIGHT
        w2c = np.linalg.inv(s["c2ws"].astype(np.float64))
        obs = dict(w2c=t(w2c[None]), K=t(s["Ks"][None]),
                   keypoints=t(s["keypoints"][None]),
                   view_mask=t(np.ones((1, len(w2c)))),
                   num_views=float(len(w2c)), constant_scale=cscale[None],
                   scan_height=height)
        final = [x.to(device, dtype) for x in out["params"]]
        got = out["vertices"].to(device, dtype)
        with torch.no_grad():
            want = fitlib.posed(model, final, obs["constant_scale"])
        worst["verts"] = max(worst["verts"],
                             float(fitlib.rel_gap(got, want).max()))
        init = fitlib.ref_init(model, [s["init"]], dtype, device)
        cfg_r = dict(cfg, num_iters=r["steps"])
        n = r["steps"] // cfg["stage_gate_den"] + 1 + PAST_GATE
        follow, _ = ref.follow(
            lambda i, ts: ref.fit_loss(cfg_r, model, obs,
                                       dict(zip(ref.PARAM_FIELDS, ts)), i,
                                       prior, vol),
            init, ref.body_lrs(cfg_r), n)
        prog = out["losses"].to(device, dtype)
        worst["steps"] = max(worst["steps"], float(
            ((prog[:, :n] - follow).abs() / follow.abs()).max()))
        tri = sv[faces]
        fn = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0],
                                dim=-1)
        bverts = got[0]
        disp, _ = ref.follow(
            lambda i, ts: ref.displacement_loss(vol, fn, cscale, bverts,
                                                ts[0], model.faces)[None],
            [torch.zeros_like(bverts)], [cfg["disp_lr"]], FOLLOW)
        got_d = prog[:, r["steps"]:r["steps"] + FOLLOW]
        worst["disp_steps"] = max(worst["disp_steps"], float(
            ((got_d - disp).abs() / disp.abs()).max()))
        cells = torch.as_tensor(sorted(vol.known), device=device)
        d, _ = vol.cells(cells)
        mine = r["volume_host"].to(device, dtype).reshape(-1)[cells]
        worst["volume"] = max(worst["volume"], float(
            ((mine - d).abs().max() / vol.spacing)))
    return [(k, worst[k], LIMITS[k]) for k in LIMITS]
