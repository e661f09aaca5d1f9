"""A multi-view mask fit: a unit is a batch of frames that the program
turns into observations (``build_observations``: keypoints, contours,
content crops, the upload) and fits together
(``fit_frames_batched(FitConfig(use_mask=True))``: the staged SMPLify
with the silhouette terms after the gate); the fitted vertices,
parameters and loss trace are read back to the host.

``correct`` holds what the window produced to the plain reference, on
every frame of every unit: its observations, the vertices at its fitted
parameters, the first steps of its loss trace (keypoints, priors, Adam),
which the reference follows step by step from the same start, and the
first masked step.  The fit is chaotic past its first steps (a float32
and a float64 run part within 200 steps on some units), so the masked
stage is not followed from the start: the parameters and gradients the
program's Adam receives at its first masked step are read back, and the
reference evaluates the staged loss (keypoints, priors and both
silhouette terms) and its gradient at those parameters.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from benchmark import counts, fitlib, harness, traffic
from benchmark.reference import body
from benchmark.reference import losses as ref
from benchmark.reference import observations as robs

# OpenPose's face order: the 17 contour points, then the 51 inner ones.
_FACE_ORDER = list(range(118, 135)) + list(range(67, 118))

# Limits of the compared numbers, each between the largest reading of
# sound runs and the smallest of the control or a planted fault (PERF.md).
LIMITS = dict(obs=0.0, verts=3.5e-6, steps=1e-3, gate_loss=1e-4,
              gate_grad=0.2)
FOLLOW = 4          # the first losses of every unit the reference follows
WARMUP_STEPS = 6    # the warm-up fit: gate at 2, masked steps 3-5


def setup(cell, seed, device, workdir, spans):
    cfg, t = cell["config"], cell["work"]["traffic"]
    paths = spans("assets", fitlib.write_assets, cfg, seed, workdir)
    model, prior = spans("load", fitlib.load_program, cfg, paths, device)
    rmodel = body.load(paths["model"], "smplx")
    pool = spans("inputs", traffic.mask_frames, rmodel, cfg, t, seed)
    views = []
    for fr in pool["frames"]:
        views.append([dict(pose=k[:25], hand_left=k[25:46],
                           hand_right=k[46:67], face=k[_FACE_ORDER])
                      for k in fr["keypoints"]])
    state = dict(cfg=cfg, traffic=t, device=device, model=model, prior=prior,
                 paths=paths, pool=pool, views=views,
                 config=fitlib.fit_config(cfg), n=t["frames_per_unit"],
                 units=t["pool_units"])
    # every shape of the window once, both sides of the gate
    spans("warmup", run, state, 0,
          fitlib.fit_config(cfg, num_iters=WARMUP_STEPS))
    return state


def frames_of(state, i):
    n = state["n"]
    k = i % state["units"]
    return list(range(k * n, (k + 1) * n))


def observations(state, frames):
    from bodyfitting_torch.fitting import body_fitting as bf

    pool, rig = state["pool"], state["cfg"]["rig"]
    ids = pool["mask_ids"]
    return [bf.build_observations(
        pool["c2ws"], pool["Ks"], state["views"][f], use_hand_face=True,
        masks=pool["frames"][f]["masks"],
        mask_c2ws=pool["c2ws"][ids], mask_Ks=pool["Ks"][ids],
        mask_num_views=rig["mask_views"], mask_imsize=rig["imsize"],
        contour_pad=8 * rig["imsize"], contour_resample=rig["contour_points"],
        mask_crop=True, mask_crop_hw=pool["crop_hw"], device=state["device"])
        for f in frames]


def run(state, i, config=None, around_obs=contextlib.nullcontext,
        around_fit=contextlib.nullcontext):
    """Unit ``i``: its frames' observations, the batched fit and the read
    back, each in a span; ``around_obs`` and ``around_fit`` wrap the first
    two (a traced run's profilers).  The record's ``gate`` holds what the
    program's Adam received at the first masked step."""
    from bodyfitting_torch.fitting import body_fitting as bf

    config = config or state["config"]
    work = dict(state["cfg"], fit=dict(state["cfg"]["fit"],
                                       num_iters=config.num_iters))
    spans = harness.Spans(state["device"])
    frames = frames_of(state, i)
    with around_obs():
        obs = spans("observations", observations, state, frames)
    init = fitlib.program_init(state["model"],
                               [state["pool"]["frames"][f]["init"]
                                for f in frames], state["device"])
    with around_fit(), \
            fitlib.gate_probe(counts.gate_step(work) + 1) as gate:
        params, result, losses = spans(
            "fit", bf.fit_frames_batched, state["model"], config, obs, init,
            state["prior"])
    out = spans("readback", _readback, params, result, losses, gate)
    return dict(frames=frames, obs=obs, out=out, spans=spans.items,
                steps=config.num_iters, opt_steps=config.num_iters,
                ops=counts.mask_fit_ops(work, len(frames)))


def _readback(params, result, losses, gate):
    return dict(vertices=result["vertices"].cpu(),
                params=fitlib.params_to_host(params), losses=losses.cpu(),
                gate={k: [t.cpu() for t in v] for k, v in gate.items()})


def unit(state, i):
    return run(state, i)


def traced_unit(state, i, trace_dir):
    return fitlib.traced(run, state, i, trace_dir)


def release(records):
    """The program's observations as host arrays; their device copies
    freed."""
    for r in records:
        obs = r.pop("obs")
        r["obs_host"] = [dict(
            contours=o.contours[0].cpu().numpy(),
            contour_valid=o.contour_valid[0].cpu().numpy(),
            crops=o.mask_crops[0].cpu().numpy(),
            origins=o.mask_crop_origins[0].cpu().numpy()) for o in obs]


def reference_obs(state, frames, dtype, device, contours=None):
    """The reference's observations of ``frames``: cameras, keypoints,
    and each mask view's contour and crop worked out again from the
    masks (or taken from ``contours``, a list of per-frame dicts)."""
    pool, rig = state["pool"], state["cfg"]["rig"]
    ids = pool["mask_ids"]

    def t(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    mv = contours or [dict(zip(("contours", "contour_valid", "crops",
                                "origins"), robs.mask_views(
        pool["frames"][f]["masks"], rig["contour_points"], pool["crop_hw"])))
        for f in frames]
    B = len(frames)
    w2c = np.linalg.inv(pool["c2ws"].astype(np.float64))
    obs = dict(
        w2c=t(np.broadcast_to(w2c, (B,) + w2c.shape)),
        K=t(np.broadcast_to(pool["Ks"], (B,) + pool["Ks"].shape)),
        keypoints=t(np.stack([pool["frames"][f]["keypoints"]
                              for f in frames])),
        view_mask=t(np.ones((B, len(w2c)))), num_views=float(len(w2c)),
        constant_scale=t(np.full(B, rig["scene_scale"])),
        mask_w2c=t(np.broadcast_to(w2c[ids], (B, len(ids), 4, 4))),
        mask_K=t(np.broadcast_to(pool["Ks"][ids], (B, len(ids), 3, 3))),
        contours=t(np.stack([m["contours"] for m in mv])),
        contour_valid=t(np.stack([m["contour_valid"] for m in mv])),
        crops=t(np.stack([m["crops"] for m in mv])),
        crop_origins=t(np.stack([m["origins"] for m in mv])),
        view_valid=t(np.ones((B, len(ids)))),
        mask_rows=mask_rows(state["ref_model"]))
    return obs, mv


def mask_rows(model):
    """Every 4th vertex, ordered by rest height (stable), as the fit
    orders the points of its silhouette term."""
    ids = np.arange(0, model.v_template.shape[0], 4)
    vt = model.v_template.cpu().numpy()[ids]
    ax = int(np.argmax(vt.max(0) - vt.min(0)))
    return torch.as_tensor(ids[np.argsort(vt[:, ax], kind="stable")],
                           device=model.v_template.device)


def check(state, records, dtype=torch.float64):
    """The compared numbers ``[(name, value, limit)]``, each the worst
    over every frame of every unit of the window."""
    device = state["device"]
    model = state["ref_model"] = body.load(state["paths"]["model"], "smplx",
                                           dtype=dtype, device=device)
    prior = ref.GMMPrior(state["paths"]["prior"], dtype=dtype, device=device)
    cfg = fitlib.objective(state["cfg"])
    worst = dict.fromkeys(LIMITS, 0.0)
    for r in records:
        frames, out = r["frames"], r["out"]
        obs, mv = reference_obs(state, frames, dtype, device)
        init = fitlib.ref_init(model, [state["pool"]["frames"][f]["init"]
                                       for f in frames], dtype, device)
        cfg_r = dict(cfg, num_iters=r["steps"])

        def loss_at(i, ts):
            return ref.fit_loss(cfg_r, model, obs,
                                dict(zip(ref.PARAM_FIELDS, ts)), i, prior)

        follow, _ = ref.follow(loss_at, init, ref.body_lrs(cfg_r), FOLLOW)
        prog = out["losses"].to(device, dtype)
        worst["steps"] = max(worst["steps"], float(
            ((prog[:, :FOLLOW] - follow).abs() / follow.abs()).max()))
        # the first masked step at the program's own parameters
        g = r["steps"] // cfg["stage_gate_den"] + 1
        ts = [x.to(device, dtype).requires_grad_(True)
              for x in out["gate"]["params"]]
        loss = loss_at(g, ts)
        grads = torch.autograd.grad(loss.sum(), ts, allow_unused=True)
        grads = [torch.zeros_like(x) if d is None else d
                 for x, d in zip(ts, grads)]
        loss = loss.detach()
        worst["gate_loss"] = max(worst["gate_loss"], float(
            ((prog[:, g] - loss).abs() / loss.abs()).max()))
        worst["gate_grad"] = max(worst["gate_grad"], float(
            fitlib.grad_gap([x.to(device, dtype)
                             for x in out["gate"]["grads"]], grads).max()))
        worst["obs"] = max(worst["obs"], max(
            float(np.abs(np.asarray(a[k], np.float64) - b[k]).max())
            for a, b in zip(mv, r["obs_host"]) for k in a))
        final = [x.to(device, dtype) for x in out["params"]]
        got = out["vertices"].to(device, dtype)
        with torch.no_grad():
            want = fitlib.posed(model, final, obs["constant_scale"])
        worst["verts"] = max(worst["verts"],
                             float(fitlib.rel_gap(got, want).max()))
    return [(k, worst[k], LIMITS[k]) for k in LIMITS]
