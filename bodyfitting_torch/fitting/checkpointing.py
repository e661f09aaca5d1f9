"""Checkpoint and resume for long fitting runs.

Counterpart of ``bodyfitting_tpu/fitting/checkpointing.py``: the SMPLify
loop runs in chunks of steps, and after each chunk the parameters, Adam's
moments and step count, and the loss history are persisted, so an
interrupted fit resumes where it stopped and ends exactly where an
unbroken :func:`smplify.fit` ends (the step is
:func:`smplify.make_step_fn`, shared with ``fit``).

The file format is this package's own (the card's machine has no flax):
``torch.save`` of plain tensors and integers, loadable with
``weights_only=True``, written to ``<path>.tmp`` and moved over
``<path>`` with ``os.replace``, so a torn write never replaces a good
checkpoint.  The loss history rides in ``<path>.losses.npy``
(``[steps, ...]``, one row a step).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from bodyfitting_torch.fitting import smplify
from bodyfitting_torch.models import body_model as bm


@dataclasses.dataclass
class FitCheckpoint:
    params: list            # the stage's parameter tensors
    opt_state: dict         # {"mu": [...], "nu": [...], "count": int}
    step: int


def save_checkpoint(path: str, ckpt: FitCheckpoint) -> None:
    """Write ``ckpt`` to ``path`` atomically (a tmp file, then
    ``os.replace``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {
        "params": [t.detach().cpu() for t in ckpt.params],
        "mu": [t.detach().cpu() for t in ckpt.opt_state["mu"]],
        "nu": [t.detach().cpu() for t in ckpt.opt_state["nu"]],
        "count": int(ckpt.opt_state["count"]),
        "step": int(ckpt.step),
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, template: FitCheckpoint) -> FitCheckpoint:
    """Read ``path``, each tensor on its template tensor's device; raises
    ``ValueError`` when the file's tensors do not match the template's
    count, shapes and dtypes."""
    d = torch.load(path, map_location="cpu", weights_only=True)

    def match(saved, tpl, what):
        if len(saved) != len(tpl) or any(
                s.shape != t.shape or s.dtype != t.dtype
                for s, t in zip(saved, tpl)):
            raise ValueError(
                f"{path}: checkpoint {what} do not match the fit's "
                f"({[tuple(s.shape) for s in saved]} vs "
                f"{[tuple(t.shape) for t in tpl]})")
        return [s.to(t.device) for s, t in zip(saved, tpl)]

    tpl = template.opt_state
    return FitCheckpoint(
        params=match(d["params"], template.params, "parameters"),
        opt_state={"mu": match(d["mu"], tpl["mu"], "first moments"),
                   "nu": match(d["nu"], tpl["nu"], "second moments"),
                   "count": int(d["count"])},
        step=int(d["step"]))


def _opt_state(opt: smplify.Adam) -> dict:
    return {"mu": opt.mu, "nu": opt.nu, "count": opt.count}


def _run_chunked(step_fn, opt: smplify.Adam, num_iters: int,
                 chunk_size: int, checkpoint_path: Optional[str]):
    """Drive ``step_fn(step)`` (which updates ``opt.params`` in place and
    returns the step's loss) in resumable chunks; returns the losses
    ``[num_iters, ...]`` on the host, the history from before a resume
    included (from the ``.losses.npy`` sidecar, so a resume with another
    ``num_iters`` restores cleanly)."""
    losses = None
    start = 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        ck = load_checkpoint(checkpoint_path, FitCheckpoint(
            params=opt.params, opt_state=_opt_state(opt), step=0))
        with torch.no_grad():
            for dst, src in zip(opt.params + opt.mu + opt.nu,
                                ck.params + ck.opt_state["mu"]
                                + ck.opt_state["nu"]):
                dst.copy_(src)
        opt.count = ck.opt_state["count"]
        start = ck.step
        lpath = checkpoint_path + ".losses.npy"
        if os.path.exists(lpath):
            prev = np.load(lpath)
            losses = np.zeros((num_iters,) + prev.shape[1:], prev.dtype)
            n = min(prev.shape[0], num_iters)
            losses[:n] = prev[:n]
    step = start
    while step < num_iters:
        n = min(chunk_size, num_iters - step)
        chunk = torch.stack([step_fn(i) for i in range(step, step + n)])
        chunk = chunk.cpu().numpy()
        if losses is None:
            losses = np.zeros((num_iters,) + chunk.shape[1:], chunk.dtype)
        losses[step:step + n] = chunk
        step += n
        if checkpoint_path:
            save_checkpoint(checkpoint_path, FitCheckpoint(
                params=opt.params, opt_state=_opt_state(opt), step=step))
            np.save(checkpoint_path + ".losses.npy", losses[:step])
    if losses is None:                  # resumed complete, no sidecar
        losses = np.zeros((num_iters,), np.float32)
    return losses


def fit_resumable(model: bm.BodyModel, config: smplify.FitConfig,
                  obs: smplify.Observations, init: smplify.FitParams,
                  pose_prior_fn, checkpoint_path: Optional[str] = None,
                  chunk_size: int = 100):
    """Run the SMPLify loop in resumable chunks.

    The trajectory of :func:`smplify.fit` (the same step function, the
    same Adam): after every ``chunk_size`` steps the state is saved at
    ``checkpoint_path``, and a checkpoint found there resumes the run.
    The returned loss trace covers all ``num_iters`` steps, resumes
    included.  A scan fit with ``config.displacement`` runs the SMPL+D
    stage too, chunked the same way and saved at ``checkpoint_path +
    '.disp'``.  Returns ``(params, result dict, losses [B, num_iters])``
    as :func:`smplify.fit` does (``[B, 2 num_iters]`` with the
    displacement stage); ``init`` is not modified."""
    if config.use_mesh:
        smplify.scan_frames(obs)            # every frame has a scan
    params = smplify.FitParams.from_tensors([t.detach().clone()
                                             for t in init.tensors()])
    opt = smplify.make_optimizer(config, params)
    step_fn = smplify.make_step_fn(model, config, obs, pose_prior_fn, opt)
    losses = _run_chunked(step_fn, opt, config.num_iters, chunk_size,
                          checkpoint_path)
    dev = init.tensors()[0].device
    losses = torch.as_tensor(losses, device=dev).T.contiguous()   # [B, T]
    with torch.no_grad():
        result = smplify.fit_result(model, params, obs)
    if config.displacement and config.use_mesh:
        disp_loss, dopt, disp = smplify.displacement_problem(
            model, config, obs, result["vertices"].detach())

        def disp_step(_step):
            disp.requires_grad_(True)
            loss = disp_loss(disp)
            (grad,) = torch.autograd.grad(loss.sum(), [disp])
            disp.requires_grad_(False)
            dopt.step([grad])
            return loss.detach()

        disp_losses = _run_chunked(
            disp_step, dopt, config.num_iters, chunk_size,
            checkpoint_path + ".disp" if checkpoint_path else None)
        result["displacement"] = disp
        losses = torch.cat([losses, torch.as_tensor(
            disp_losses, device=dev).T], dim=1)
    return params, result, losses
