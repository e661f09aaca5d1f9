"""The program's spans (``utils/observability.py:span``): with no profiler
a span is one shared no-op and never builds a ``record_function``; under
a profiler each fit step is a ``fit.step`` holding one ``fit.loss`` then
one ``fit.grad``, followed by one ``fit.update``, and each frame's
contour tracing one ``observations.contours``; a profiler stopped from a
wrapper of ``Adam.step`` finds no span open; the spans leave a fit's
numbers bitwise as they were; and ``StageTimer``'s stages are spans
too."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from bodyfitting_torch.fitting import body_fitting as bf
from bodyfitting_torch.fitting import smplify
from bodyfitting_torch.losses.priors import synthetic_gmm_prior
from bodyfitting_torch.models import body_model as bm
from bodyfitting_torch.utils import observability as ob

IMSIZE = 64
N_FRAMES = 2
STEPS = 3
FIT_SPANS = ("fit.step", "fit.loss", "fit.grad", "fit.update")


def _ring(n, dist=2.5, focal=70.0):
    c2ws, Ks = [], []
    for th in np.linspace(0, 2 * np.pi, n, endpoint=False):
        eye = np.array([dist * np.sin(th), 0.0, dist * np.cos(th)])
        z = -eye / np.linalg.norm(eye)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        c2w = np.eye(4)
        c2w[:3, :3] = np.stack([x, np.cross(z, x), z], 1)
        c2w[:3, 3] = eye
        c2ws.append(c2w.astype(np.float32))
        Ks.append(np.array([[focal, 0, IMSIZE / 2], [0, focal, IMSIZE / 2],
                            [0, 0, 1]], np.float32))
    return np.stack(c2ws), np.stack(Ks)


def _frame(model, seed):
    """Three keypoint views of the rest body's joints, with noise, and
    two mask views: an ellipse each."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        joints = bm.forward(model, bm.BodyParams.zeros(
            model, 1, "cpu")).joints[0].numpy() * 0.35
    c2ws, Ks = _ring(3)
    views = []
    for c2w, K in zip(c2ws, Ks):
        w2c = np.linalg.inv(c2w)
        uv = (joints @ w2c[:3, :3].T + w2c[:3, 3]) @ K.T
        uv = uv[:, :2] / uv[:, 2:3] + rng.normal(scale=0.5, size=(len(uv), 2))
        kp = np.concatenate([uv, np.ones((len(uv), 1))], 1).astype(np.float32)
        views.append(dict(pose=kp[:25], hand_left=kp[25:46],
                          hand_right=kp[46:67],
                          face=np.concatenate([kp[118:], kp[67:118]])))
    yy, xx = np.mgrid[:IMSIZE, :IMSIZE]
    masks = [((xx - 32 - dx) / 9.0) ** 2 + ((yy - 32) / 24.0) ** 2 <= 1.0
             for dx in rng.integers(-3, 4, size=2)]
    return bf.build_observations(
        c2ws, Ks, views, use_hand_face=True,
        masks=[m.astype(np.float32) for m in masks], mask_c2ws=c2ws[:2],
        mask_Ks=Ks[:2], mask_num_views=2, mask_imsize=IMSIZE,
        contour_resample=64, mask_crop=True, mask_crop_hw=(56, 32),
        device="cpu")


@pytest.fixture(scope="module")
def problem():
    model = bm.synthetic_model("smplx", num_verts=400, seed=7, device="cpu")
    return model, synthetic_gmm_prior(device="cpu")


def _observe(model):
    return [_frame(model, 10 + f) for f in range(N_FRAMES)]


def _fit(model, prior, obs):
    config = smplify.FitConfig(num_iters=STEPS, use_mask=True,
                               stage_gate_den=3, imsize=float(IMSIZE))
    init = [smplify.FitParams.init(model, device="cpu")
            for _ in range(N_FRAMES)]
    params, _, losses = bf.fit_frames_batched(model, config, obs, init,
                                              prior)
    return params, losses


def _user_spans(log_dir):
    """``(name, start, end)`` of every ``user_annotation`` event of the
    Chrome trace that ``profiler_trace(log_dir)`` wrote, in start order."""
    with open(log_dir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    return sorted(((e["name"], float(e["ts"]), float(e["ts"]) + e["dur"])
                   for e in events
                   if e.get("cat") == "user_annotation" and "dur" in e),
                  key=lambda s: s[1])


def test_span_is_a_shared_noop_without_a_profiler(problem, monkeypatch):
    """(a) No profiler: one shared object, and a fit and a masked
    ``build_observations`` never build a ``record_function``."""
    assert ob.span("fit.step") is ob.span("observations.contours")

    def refuse(*a, **kw):
        raise AssertionError("record_function built with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    model, prior = problem
    _, losses = _fit(model, prior, _observe(model))
    assert losses.shape == (N_FRAMES, STEPS)


def test_profiled_fit_nests_its_spans(problem, tmp_path):
    """(b) One ``fit.step`` a step, each holding exactly one ``fit.loss``
    then one ``fit.grad`` and followed by one ``fit.update`` before the
    next step; one ``observations.contours`` a frame."""
    model, prior = problem
    with ob.profiler_trace(str(tmp_path)):
        obs = _observe(model)
        _fit(model, prior, obs)
    spans = _user_spans(tmp_path)
    steps = [s for s in spans if s[0] == "fit.step"]
    assert len(steps) == STEPS
    assert sum(s[0] == "observations.contours" for s in spans) == N_FRAMES
    ends = [a for _, a, _ in steps[1:]] + [float("inf")]
    for (_, a, b), nxt in zip(steps, ends):
        inside = [n for n, c, d in spans if a <= c and d <= b
                  and n in FIT_SPANS[1:]]
        after = [n for n, c, d in spans if b <= c and d <= nxt
                 and n in FIT_SPANS]
        assert inside == ["fit.loss", "fit.grad"]
        assert after == ["fit.update"]
    for name in FIT_SPANS[1:]:
        assert sum(s[0] == name for s in spans) == STEPS, name


def test_profiler_stopped_by_a_step_hook_finds_no_span_open(
        problem, tmp_path, monkeypatch):
    """A bounded profiler that counts steps from a wrapper of
    ``Adam.step`` and stops after step 1: every program span ends inside
    the last profiled step, none is left open to be closed when the
    trace is written."""
    model, prior = problem
    obs = _observe(model)
    path = tmp_path / "trace.json"
    orig = smplify.Adam.step
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(
                     str(path))) as prof:
        def step(self, grads):
            orig(self, grads)
            prof.step()

        monkeypatch.setattr(smplify.Adam, "step", step)
        _fit(model, prior, obs)
    spans = _user_spans(tmp_path)
    (last,) = [s for s in spans if s[0].startswith("ProfilerStep#")]
    ours = [s for s in spans if s[0] in FIT_SPANS]
    assert [s[0] for s in ours] == list(FIT_SPANS)
    assert all(last[1] <= a and b <= last[2] for _, a, b in ours)


def test_profiler_leaves_the_fit_bitwise(problem, tmp_path):
    """(c) The same losses and parameters, bit for bit, with the
    profiler recording and without it."""
    model, prior = problem
    obs = _observe(model)
    params, losses = _fit(model, prior, obs)
    with ob.profiler_trace(str(tmp_path)):
        params_on, losses_on = _fit(model, prior, obs)
    assert torch.equal(losses, losses_on)
    for a, b in zip(params.tensors(), params_on.tensors()):
        assert torch.equal(a, b)


def test_stage_is_a_span_and_still_timed(tmp_path):
    """(d) ``StageTimer.stage`` opens its span under a profiler and sums
    its totals with or without one."""
    timer = ob.StageTimer()
    with timer.stage("prep/observations"):
        pass
    with ob.profiler_trace(str(tmp_path)):
        with timer.stage("prep/observations"):
            torch.ones(8).sum()
        with timer.stage("fit/dispatch"):
            pass
    names = [s[0] for s in _user_spans(tmp_path)]
    assert names == ["prep/observations", "fit/dispatch"]
    s = timer.summary()
    assert s["prep/observations"]["calls"] == 2
    assert s["fit/dispatch"]["calls"] == 1
    assert timer.totals["prep/observations"] > 0.0
