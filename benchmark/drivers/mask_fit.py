"""A multi-view fit: a unit is a batch of frames that the program turns
into observations (``build_observations``: keypoints and, with masks,
contours, content crops; the upload) and fits together
(``fit_frames_batched(FitConfig(use_mask=...))``: the staged SMPLify,
with the silhouette terms after the gate when the configuration's fit
uses masks); the fitted vertices, parameters and loss trace are read
back to the host.

``correct`` holds what the window produced to the plain reference, on
every frame of every unit: its observations, the vertices at its fitted
parameters, the first steps of its loss trace (keypoints, priors, Adam),
which the reference follows step by step from the same start, and with
masks the first masked step.  The fit is chaotic past its first steps (a
float32 and a float64 run part within 200 steps on some units), so the
masked stage is not followed from the start: the parameters and
gradients the program's Adam receives at its first masked step are read
back, and the reference evaluates the staged loss (keypoints, priors and
both silhouette terms) and its gradient at those parameters.  Losses and
gradients are held to what float32 rounding can explain: where the
landmarks' whole degree of yaw lies within rounding of its threshold, to
the nearer of the reference's two branches (``losses.yaw_ties``,
``losses.follow_branches``); at the masked step, less the jumps of the
decisions that lie within rounding of theirs, which the reference finds
at those parameters (``losses.fit_loss_ties`` for the loss,
``losses.fit_grad_ties`` for each leaf of the gradient).
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
# sound runs and the smallest of the control or a planted fault (PERF.md);
# the ``gate_*`` numbers exist with masks only.
LIMITS = dict(obs=0.0, verts=3.5e-6, steps=1e-3, gate_loss=8e-6,
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
                 units=t["pool_units"], detail=[])
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
    if not state["cfg"]["fit"].get("use_mask"):
        return [bf.build_observations(pool["c2ws"], pool["Ks"],
                                      state["views"][f], use_hand_face=True,
                                      device=state["device"])
                for f in frames]
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
    program's Adam received at the first masked step (empty without
    masks)."""
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
    probe = (fitlib.gate_probe(counts.gate_step(work) + 1)
             if config.use_mask else contextlib.nullcontext({}))
    with around_fit(), probe as gate:
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
        r["obs_host"] = [dict(keypoints=o.keypoints[0].cpu().numpy())
                         for o in obs]
        for h, o in zip(r["obs_host"], obs):
            if o.mask_crops is not None:
                h.update(contours=o.contours[0].cpu().numpy(),
                         contour_valid=o.contour_valid[0].cpu().numpy(),
                         crops=o.mask_crops[0].cpu().numpy(),
                         origins=o.mask_crop_origins[0].cpu().numpy())


def reference_obs(state, frames, dtype, device, contours=None):
    """The reference's observations of ``frames``: cameras and keypoints,
    and with masks each mask view's contour and crop worked out again
    from the masks (or taken from ``contours``, a list of per-frame
    dicts); and per frame the observations the ``obs`` check compares."""
    pool, rig = state["pool"], state["cfg"]["rig"]
    ids = pool["mask_ids"]

    def t(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    B = len(frames)
    w2c = np.linalg.inv(pool["c2ws"].astype(np.float64))
    obs = dict(
        w2c=t(np.broadcast_to(w2c, (B,) + w2c.shape)),
        K=t(np.broadcast_to(pool["Ks"], (B,) + pool["Ks"].shape)),
        keypoints=t(np.stack([pool["frames"][f]["keypoints"]
                              for f in frames])),
        view_mask=t(np.ones((B, len(w2c)))), num_views=float(len(w2c)),
        constant_scale=t(np.full(B, rig["scene_scale"])))
    want = [dict(keypoints=pool["frames"][f]["keypoints"]) for f in frames]
    if not state["cfg"]["fit"].get("use_mask"):
        return obs, want
    mv = contours or [dict(zip(("contours", "contour_valid", "crops",
                                "origins"), robs.mask_views(
        pool["frames"][f]["masks"], rig["contour_points"], pool["crop_hw"])))
        for f in frames]
    obs.update(
        mask_w2c=t(np.broadcast_to(w2c[ids], (B, len(ids), 4, 4))),
        mask_K=t(np.broadcast_to(pool["Ks"][ids], (B, len(ids), 3, 3))),
        contours=t(np.stack([m["contours"] for m in mv])),
        contour_valid=t(np.stack([m["contour_valid"] for m in mv])),
        crops=t(np.stack([m["crops"] for m in mv])),
        crop_origins=t(np.stack([m["origins"] for m in mv])),
        view_valid=t(np.ones((B, len(ids)))),
        mask_rows=mask_rows(state["ref_model"]))
    return obs, [dict(w, **m) for w, m in zip(want, mv)]


def mask_rows(model):
    """Every 4th vertex, ordered by rest height (stable), as the fit
    orders the points of its silhouette term."""
    ids = np.arange(0, model.v_template.shape[0], 4)
    vt = model.v_template.cpu().numpy()[ids]
    ax = int(np.argmax(vt.max(0) - vt.min(0)))
    return torch.as_tensor(ids[np.argsort(vt[:, ax], kind="stable")],
                           device=model.v_template.device)


def loss_gap(prog, branches, ties=0.0):
    """Per frame, ``max(0, min_b |prog - branches[b]| - ties) /
    |branches[0]|``: the relative gap of the program's loss from the
    reference's nearest branch (``[branches, B]``: its own decisions, and
    the other whole degree of a yaw within rounding of a half degree) that
    the mask term's near-ties ``ties`` (:func:`losses.fit_loss_ties`) do
    not explain."""
    gap = (prog - branches).abs().reshape(-1, prog.shape[-1]).min(0).values
    return (gap - ties).clamp(min=0) / branches.reshape(
        -1, prog.shape[-1])[0].abs()


def _gate(state, worst, r, obs, loss_at, prog, cfg_r, prior):
    """``gate_loss`` and ``gate_grad`` of unit ``r`` into ``worst``: the
    staged loss and its gradient at the parameters the program's Adam
    received at the first masked step, each against the reference's
    nearer yaw branch and less what its near-ties explain."""
    device, dtype = prog.device, prog.dtype
    g = r["steps"] // cfg_r["stage_gate_den"] + 1
    gate = r["out"]["gate"]
    p = dict(zip(ref.PARAM_FIELDS, [x.to(device, dtype)
                                    for x in gate["params"]]))
    got = [x.to(device, dtype) for x in gate["grads"]]
    deg = ref.yaw_ties(state["ref_model"], p)
    allow = ref.fit_grad_ties(cfg_r, state["ref_model"], obs, p, g, prior)

    def at(d):
        ts = [x.clone().requires_grad_(True) for x in p.values()]
        loss = loss_at(g, ts, d)
        grads = torch.autograd.grad(loss.sum(), ts, allow_unused=True)
        return loss.detach(), [torch.zeros_like(x) if e is None else e
                                for x, e in zip(ts, grads)]

    sides = [at(d) for d in ([None] if deg is None else [None, deg])]
    branches = torch.stack([loss for loss, _ in sides])
    gap = torch.stack([fitlib.grad_gap(got, grads, allow=allow)
                       for _, grads in sides]).min(0).values
    worst["gate_grad"] = max(worst["gate_grad"], float(gap.max()))
    want = sides[0][1]
    ties = ref.fit_loss_ties(cfg_r, state["ref_model"], obs, p, g)
    state["detail"] += [
        dict(frame=f, raw=float(a), ties=float(b), grad_raw=float(c),
             grad_ties=float(d), grad=float(e))
        for f, a, b, c, d, e in zip(
            r["frames"], loss_gap(prog[:, g], branches[:1]),
            ties / branches[0].abs(), fitlib.grad_gap(got, want),
            fitlib.grad_gap(want, want, allow=-allow), gap)]
    worst["gate_loss"] = max(worst["gate_loss"], float(
        loss_gap(prog[:, g], branches, ties).max()))


def check(state, records, dtype=torch.float64):
    """The compared numbers ``[(name, value, limit)]``, each the worst
    over every frame of every unit of the window.  With masks,
    ``state["detail"]`` gains each frame's masked-step loss and gradient
    gaps before and after the near-ties' allowance."""
    device = state["device"]
    model = state["ref_model"] = body.load(state["paths"]["model"], "smplx",
                                           dtype=dtype, device=device)
    prior = ref.GMMPrior(state["paths"]["prior"], dtype=dtype, device=device)
    cfg = fitlib.objective(state["cfg"])
    masked = bool(state["cfg"]["fit"].get("use_mask"))
    worst = {k: 0.0 for k in LIMITS if masked or not k.startswith("gate_")}
    for r in records:
        frames, out = r["frames"], r["out"]
        obs, want = reference_obs(state, frames, dtype, device)
        init = fitlib.ref_init(model, [state["pool"]["frames"][f]["init"]
                                       for f in frames], dtype, device)
        cfg_r = dict(cfg, num_iters=r["steps"])

        def loss_at(i, ts, deg=None):
            return ref.fit_loss(cfg_r, model, obs,
                                dict(zip(ref.PARAM_FIELDS, ts)), i, prior,
                                deg=deg)

        # each frame against the nearer branch of its followed steps
        follow = ref.follow_branches(loss_at, init, ref.body_lrs(cfg_r),
                                     FOLLOW, model)
        prog = out["losses"].to(device, dtype)
        worst["steps"] = max(worst["steps"], float(
            ((prog[:, :FOLLOW] - follow).abs() / follow.abs()).amax(2)
            .min(0).values.max()))
        if masked:
            _gate(state, worst, r, obs, loss_at, prog, cfg_r, prior)
        worst["obs"] = max(worst["obs"], max(
            float(np.abs(np.asarray(a[k], np.float64) - b[k]).max())
            for a, b in zip(want, r["obs_host"]) for k in a))
        final = [x.to(device, dtype) for x in out["params"]]
        got = out["vertices"].to(device, dtype)
        with torch.no_grad():
            want_v = fitlib.posed(model, final, obs["constant_scale"])
        worst["verts"] = max(worst["verts"],
                             float(fitlib.rel_gap(got, want_v).max()))
    return [(k, v, LIMITS[k]) for k, v in worst.items()]
