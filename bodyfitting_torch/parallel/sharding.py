"""Multi-device fits: the frame (and view) axes split over a process mesh.

Counterpart of ``bodyfitting_tpu/parallel/sharding.py``.  The JAX package
is single-controller: one process places sharded arrays on a
``jax.sharding.Mesh`` and ``jit`` runs them.  Here every device has its
own process (SPMD, ``torch.distributed``), and a
``torch.distributed.device_mesh.DeviceMesh`` with dimensions
``("frames", "views")`` names the process groups:

  * ``frames`` — data parallelism.  Each rank fits a contiguous block of
    frames; frames share no parameters, so the step has no collective.
  * ``views`` — the keypoint views of a frame split over ranks (many-
    camera rigs such as GeneBody's 48 views): one sum of per-view terms a
    step, and the joints' gradient summed over the group in the
    backward (:mod:`~bodyfitting_torch.ops.comm`).

Every rank calls :func:`fit_sequence_sharded` with the whole batch and
gets the whole result back, gathered from every rank, so callers look
as they do with the JAX package.  :func:`init_world` joins the process
group: the ``torchrun`` one, or a world of one in this process.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from bodyfitting_torch.device import default_device
from bodyfitting_torch.fitting import smplify
from bodyfitting_torch.ops import comm

# per-view observation fields, split on axis 1 over the views axis
VIEW_FIELDS = ("w2cs", "Ks", "keypoints", "view_mask")


def init_world(device=None) -> torch.device:
    """Join the process group and return this rank's device.

    Started by ``torchrun`` (``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``
    set), the rank takes card ``LOCAL_RANK`` and joins the launcher's
    group; otherwise a world of one is made in this process (no
    network).  The backend is the device's: ``nccl`` on a CUDA device,
    ``gloo`` on the CPU.  A world that is already initialised is
    kept."""
    launched = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if launched and device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    device = default_device(device)
    bound = None
    if device.type == "cuda":
        if device.index is not None:
            torch.cuda.set_device(device)
        # NCCL binds the rank's card (else it guesses from the rank)
        bound = torch.device("cuda", torch.cuda.current_device())
    if dist.is_initialized():
        return device
    backend = "nccl" if device.type == "cuda" else "gloo"
    if launched:
        dist.init_process_group(backend, init_method="env://",
                                device_id=bound)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, device_id=bound,
                                timeout=datetime.timedelta(minutes=10))
    return device


def make_mesh(n_frames_shards: Optional[int] = None, n_view_shards: int = 1,
              devices=None) -> DeviceMesh:
    """A ``(frames, views)`` mesh over the ranks ``devices`` (default:
    every rank of the initialised world, in rank order).  Raises when no
    world is initialised (:func:`init_world`)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "bodyfitting_torch.parallel.init_world() (or "
                           "start the program with torchrun) first")
    ranks = torch.as_tensor(list(range(dist.get_world_size()))
                            if devices is None else list(devices))
    total = ranks.numel()
    if n_frames_shards is None:
        n_frames_shards = total // n_view_shards
    if n_frames_shards * n_view_shards != total:
        raise ValueError(f"{n_frames_shards} x {n_view_shards} != {total} "
                         f"ranks")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(kind, ranks.reshape(n_frames_shards, n_view_shards),
                      mesh_dim_names=("frames", "views"))


def axis(mesh: DeviceMesh, name: str):
    """``(group, rank in it, size)`` of the mesh's dimension ``name``."""
    dim = mesh.mesh_dim_names.index(name)
    return (mesh.get_group(name), mesh.get_local_rank(name),
            mesh.shape[dim])


def _block(x: torch.Tensor, dim: int, rank: int, size: int, what: str):
    n = x.shape[dim]
    if n % size:
        raise ValueError(f"{what}: {n} along axis {dim} does not divide "
                         f"over {size} ranks")
    return x.narrow(dim, rank * (n // size), n // size)


def obs_sharding(mesh: DeviceMesh, obs: smplify.Observations):
    """This rank's block of ``obs``: frames in contiguous blocks on axis
    0, and the per-view fields (:data:`VIEW_FIELDS`) on axis 1 when the
    mesh has more than one view rank."""
    _, fr, nf = axis(mesh, "frames")
    _, vr, nv = axis(mesh, "views")

    def local(name, x):
        if x is None:
            return None
        if dataclasses.is_dataclass(x):
            return type(x)(**{f.name: local(name, getattr(x, f.name))
                              for f in dataclasses.fields(x)})
        x = _block(x, 0, fr, nf, name)
        if name in VIEW_FIELDS and x.ndim >= 2 and nv > 1:
            x = _block(x, 1, vr, nv, name)
        return x

    return smplify.Observations(**{
        f.name: local(f.name, getattr(obs, f.name))
        for f in dataclasses.fields(obs)})


def params_sharding(mesh: DeviceMesh, params):
    """This rank's frame block of a dataclass of ``[B, ...]`` tensors
    (:class:`smplify.FitParams`)."""
    _, fr, nf = axis(mesh, "frames")

    def local(x):
        if dataclasses.is_dataclass(x):
            return type(x)(**{f.name: local(getattr(x, f.name))
                              for f in dataclasses.fields(x)})
        return None if x is None else _block(x, 0, fr, nf, "params")

    return local(params)


def gather_frames(mesh: DeviceMesh, params, result: dict, losses):
    """Every rank's ``(params, result, losses)`` blocks gathered along the
    frame axis, in rank order, on every rank (no autograd)."""
    group, _, nf = axis(mesh, "frames")
    if nf == 1:
        return params, result, losses

    def whole(t):
        return comm.raw_all_gather(t, group)

    params = smplify.FitParams.from_tensors(
        [whole(t) for t in params.tensors()])
    return params, {k: whole(v) for k, v in result.items()}, whole(losses)


def fit_sequence_sharded(model, config: smplify.FitConfig,
                         obs: smplify.Observations, init: smplify.FitParams,
                         pose_prior_fn, mesh: Optional[DeviceMesh] = None):
    """Fit a batch of frames split over the mesh's ``frames`` axis (and
    its keypoint views over ``views``).

    Every rank passes the whole batch (``obs`` / ``init`` with a leading
    frame axis whose length the frames dimension divides; the keypoint
    views divided by the views dimension) and gets back what
    :func:`smplify.fit` returns for it, gathered from every rank."""
    if mesh is None:
        mesh = make_mesh()
    views, _, _ = axis(mesh, "views")
    params, result, losses = smplify.fit(
        model, config, obs_sharding(mesh, obs), params_sharding(mesh, init),
        pose_prior_fn, view_group=views)
    return gather_frames(mesh, params, result, losses)


def training_step(model, config: smplify.FitConfig, pose_prior_fn,
                  step_idx: int = 0, view_group=None):
    """One Adam step of the batched fit, the production step body
    (:func:`smplify.make_step_fn`, with its model reductions).

    Returns ``(make_opt, step)``: ``make_opt(params)`` builds the
    optimizer over a :class:`smplify.FitParams`, and ``step(opt, obs) ->
    (params, loss [B])`` runs one step at fit iteration ``step_idx``
    (past ``num_iters // stage_gate_den`` for the mask and mesh terms),
    updating the optimizer's parameters in place."""

    def make_opt(params):
        return smplify.make_optimizer(config, params)

    def step(opt, obs):
        step_fn = smplify.make_step_fn(model, config, obs, pose_prior_fn,
                                       opt, view_group)
        loss = step_fn(step_idx)
        return smplify.FitParams.from_tensors(opt.params), loss

    return make_opt, step
