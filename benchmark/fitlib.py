"""The program's side of the fit cells: its loaders, its fit settings,
its parameters, the step probe of a traced run, and the reference's
view of the same parameters.  Drivers of fit cells share it.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from benchmark import traffic
from benchmark.reference import body
from benchmark.reference import losses as ref

# The objective's constants as the apps state them (SMPLify's weights);
# the configuration's ``fit`` adds the rest (its steps and gate).
OBJECTIVE = dict(sigma=100.0, pose_prior_weight=4.78, angle_prior_weight=15.2,
                 shape_prior_weight=5.0, mask_weight=5.0, pc_weight=5.0,
                 step_size=1e-2, transl_lr=0.1, disp_lr=5e-2)


def write_assets(cfg, seed, workdir):
    """The configuration's model and prior files for ``seed``."""
    os.makedirs(workdir, exist_ok=True)
    paths = dict(model=os.path.join(workdir, f"{cfg['model']['type']}.npz"),
                 prior=os.path.join(workdir, "gmm_08.pkl"))
    traffic.write_model(paths["model"], cfg, seed)
    traffic.write_gmm(paths["prior"], seed)
    return paths


def load_program(cfg, paths, device, dtype=torch.float32):
    """The model and pose prior through the program's own readers; a SMPL
    model gets the SPIN joint mapper, as the apps load it."""
    from bodyfitting_torch.losses.priors import load_gmm_prior
    from bodyfitting_torch.models import body_model as bm

    m = cfg["model"]
    model = bm.load_model(paths["model"], model_type=m["type"],
                          num_betas=m["betas"],
                          num_expressions=m.get("expressions", 10),
                          num_hand_pca=m.get("hand_pca", 6), dtype=dtype,
                          device=device)
    if m["type"] == "smpl":
        model = bm.spin_joint_mapper_for_smpl(model)
    return model, load_gmm_prior(paths["prior"], dtype=dtype, device=device)


def fit_config(cfg, **over):
    from bodyfitting_torch.fitting import smplify

    kw = {k: v for k, v in cfg["fit"].items() if k != "sdf_resolution"}
    kw.update(over)
    return smplify.FitConfig(**kw)


def program_init(model, inits, device):
    """The program's initial parameters of each frame's ``init`` dict."""
    from bodyfitting_torch.fitting import smplify

    return [smplify.FitParams.init(
        model, init_global_orient=torch.as_tensor(d["global_orient"])[None],
        init_body_pose=torch.as_tensor(d["body_pose"])[None], device=device)
        for d in inits]


def params_to_host(params):
    return [t.detach().cpu() for t in params.tensors()]


def objective(cfg):
    return dict(OBJECTIVE, **cfg["fit"])


def ref_init(model, inits, dtype, device):
    """The same start as :func:`program_init`, as the reference's tensors
    in ``losses.PARAM_FIELDS`` order."""
    B = len(inits)
    sizes = dict(betas=10, global_orient=3,
                 body_pose=3 * model.num_body_joints,
                 expression=10 if model.kind == "smplx" else 0, jaw_pose=3,
                 leye_pose=3, reye_pose=3, left_hand_pose=6,
                 right_hand_pose=6, global_transl=3, body_scale=1)
    out = []
    for f in ref.PARAM_FIELDS:
        if f in ("global_orient", "body_pose"):
            a = np.stack([d[f] for d in inits])
        elif f == "body_scale":
            a = np.ones((B, 1))
        else:
            a = np.zeros((B, sizes[f]))
        out.append(torch.as_tensor(a, dtype=dtype, device=device))
    return out


def posed(model, tensors, constant_scale):
    """Vertices as the fits return them: ``(v + transl) * scale *
    constant_scale``."""
    p = dict(zip(ref.PARAM_FIELDS, tensors))
    v, _ = body.forward(model, p)
    s = (p["body_scale"] * constant_scale[:, None])[:, :, None]
    return (v + p["global_transl"][:, None]) * s


def rel_gap(got, want):
    """``max |got - want| / max |want|`` per frame (leading axis)."""
    got, want = got.double(), want.double()
    d = (got - want).abs().reshape(len(got), -1).max(1).values
    return d / want.abs().reshape(len(want), -1).max(1).values.clamp(
        min=1e-30)


def step_slice(config, steps):
    """``(first, last, gate)``: at most ``steps`` fit steps centred on the
    gate, from step 1 on (the profiler needs a step to warm up in)."""
    gate = config.num_iters // config.stage_gate_den
    steps = min(steps, config.num_iters - 2)
    first = max(1, gate - steps // 2)
    return first, first + steps, gate


def traced(run, state, i, trace_dir, slice_steps=20):
    """``run(state, i)`` with its observations profiled and a slice of
    ``slice_steps`` fit steps centred on the gate (``step_slice``); the
    record's ``trace`` names the two trace files and the slice."""
    from torch.profiler import schedule

    from benchmark import harness

    device = state["device"]
    first, last, gate = step_slice(state["config"], slice_steps)
    obs_path = os.path.join(trace_dir, "observations.json")
    step_path = os.path.join(trace_dir, "steps.json")

    @contextlib.contextmanager
    def around_fit():
        sched = schedule(wait=first - 1, warmup=1, active=last - first,
                         repeat=1)
        with harness.profile_to(step_path, device, sched) as prof, \
                step_probe(prof):
            yield

    rec = run(state, i, around_obs=lambda: harness.profile_to(obs_path,
                                                              device),
              around_fit=around_fit)
    rec["trace"] = dict(observations=obs_path, steps=step_path,
                        slice=(first, last), gate=gate)
    return rec


@contextlib.contextmanager
def gate_probe(step):
    """The parameters and gradients the program's Adam receives at fit
    step ``step`` (counted from 0), as device copies under ``params`` and
    ``grads`` of the yielded dict, filled once that step has run."""
    from bodyfitting_torch.fitting import smplify

    got, calls = {}, {}
    orig = smplify.Adam.step

    def probe(self, grads):
        n = calls[id(self)] = calls.get(id(self), -1) + 1
        if n == step and not got:
            got["params"] = [p.detach().clone() for p in self.params]
            got["grads"] = [g.detach().clone() for g in grads]
        orig(self, grads)

    smplify.Adam.step = probe
    try:
        yield got
    finally:
        smplify.Adam.step = orig


def grad_gap(got, want, floor=1e-3, allow=None):
    """Per frame (leading axis), the worst leaf's gap between the norms of
    ``got`` and ``want`` (lists of leaves ``[B, ...]``), less the leaf's
    ``allow [B, leaves]`` (what the reference's near-ties explain), over
    the larger of the reference's norm of that leaf and of the frame's
    median leaf; a leaf whose reference gradient is under ``floor`` times
    the median leaf's is nought to rounding and left out."""
    def norms(leaves):
        return torch.stack([x.double().reshape(len(x), -1).norm(dim=1)
                            for x in leaves], dim=1)           # [B, leaves]

    g, w = norms(got), norms(want)
    med = w.median(dim=1, keepdim=True).values
    gap = (g - w).abs()
    if allow is not None:
        gap = (gap - allow.to(gap)).clamp(min=0)
    gap = gap / torch.maximum(w, med)
    return torch.where(w >= floor * med, gap,
                       torch.zeros_like(gap)).max(dim=1).values


@contextlib.contextmanager
def step_probe(prof):
    """``prof.step()`` after every Adam step of the program's fits, for
    the bounded profile of a traced run."""
    from bodyfitting_torch.fitting import smplify

    orig = smplify.Adam.step

    def step(self, grads):
        orig(self, grads)
        prof.step()

    smplify.Adam.step = step
    try:
        yield
    finally:
        smplify.Adam.step = orig
