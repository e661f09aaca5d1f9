"""Sequence-level fitting with temporal coupling.

Counterpart of ``bodyfitting_tpu/fitting/sequence.py``.  A batch of
frames is one optimisation: the sum of the per-frame SMPLify losses plus
squared velocities of body pose, global orientation and translation,
(optionally) accelerations, and a betas-consistency term that ties the
frames to one body shape.  ``frame_valid`` (``[F]`` of 0/1) excludes
padding frames: their data losses and every temporal term that touches
them carry zero weight.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from bodyfitting_torch.fitting import smplify


@dataclasses.dataclass(frozen=True)
class TemporalConfig:
    pose_velocity_weight: float = 100.0
    orient_velocity_weight: float = 100.0
    transl_velocity_weight: float = 1000.0
    betas_consistency_weight: float = 100.0
    acceleration_weight: float = 0.0


def temporal_loss(params: smplify.FitParams, tcfg: TemporalConfig,
                  frame_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The smoothness terms over the leading frame axis of ``params``."""
    F = params.global_transl.shape[0]
    if frame_valid is None:
        frame_valid = params.global_transl.new_ones((F,))
    v_pair = frame_valid[1:] * frame_valid[:-1]
    v_tri = (frame_valid[2:] * frame_valid[1:-1] * frame_valid[:-2]
             if F > 2 else None)

    def vel(x):
        d2 = ((x[1:] - x[:-1]) ** 2).sum(dim=tuple(range(1, x.dim())))
        return (d2 * v_pair).sum()

    def acc(x):
        if v_tri is None:
            return x.new_zeros(())
        d2 = ((x[2:] - 2 * x[1:-1] + x[:-2]) ** 2).sum(
            dim=tuple(range(1, x.dim())))
        return (d2 * v_tri).sum()

    body = params.body
    total = tcfg.pose_velocity_weight * vel(body.body_pose)
    total = total + tcfg.orient_velocity_weight * vel(body.global_orient)
    total = total + tcfg.transl_velocity_weight * vel(params.global_transl)
    n_valid = torch.clamp(frame_valid.sum(), min=1.0)
    mean_betas = (body.betas * frame_valid[:, None]).sum(
        0, keepdim=True) / n_valid
    total = total + tcfg.betas_consistency_weight * (
        (body.betas - mean_betas) ** 2 * frame_valid[:, None]).sum()
    if tcfg.acceleration_weight:
        total = total + tcfg.acceleration_weight * (
            acc(body.body_pose) + acc(params.global_transl))
    return total


def fit_sequence(model, config: smplify.FitConfig, obs: smplify.Observations,
                 init: smplify.FitParams, pose_prior_fn,
                 tcfg: TemporalConfig = TemporalConfig(),
                 frame_valid: Optional[torch.Tensor] = None):
    """Fit the frames of ``obs`` / ``init`` (a leading frame axis) jointly
    with the temporal terms.  Returns ``(params, result dict (batched),
    losses [num_iters])``: one sequence-level loss curve, each loss taken
    before its step's update.  Uses the same reduced models as
    :func:`smplify.fit`, so per-frame trajectories agree with it."""
    params = smplify.FitParams.from_tensors(
        [t.detach().clone() for t in init.tensors()])
    opt = smplify.make_optimizer(config, params)
    loss_model, joints_model, mask_rows = smplify.loss_models(model, config)
    step_obs = smplify.step_observations(obs)
    leaves = opt.params
    losses = []
    for step in range(config.num_iters):
        for p in leaves:
            p.requires_grad_(True)
        cur = smplify.FitParams.from_tensors(leaves)
        frame_losses, _ = smplify.fit_loss(
            loss_model, config, cur, step_obs, step, pose_prior_fn,
            joints_model=joints_model, mask_vertex_rows=mask_rows)
        if frame_valid is not None:
            frame_losses = frame_losses * frame_valid
        total = frame_losses.sum() + temporal_loss(cur, tcfg, frame_valid)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        for p in leaves:
            p.requires_grad_(False)
        opt.step(grads)
        losses.append(total.detach())
    with torch.no_grad():
        result = smplify.fit_result(model, params, obs)
    return params, result, torch.stack(losses)
