"""Tensor parallelism: the body model's vertex axis split over ranks.

Counterpart of ``bodyfitting_tpu/parallel/tensor.py``.  Data parallelism
over frames (:mod:`.sharding`) is the throughput path; vertex sharding is
the capacity path, for models or displacement fields one card cannot
hold.  Linear blend skinning is vertex-parallel: the blend shapes
``[S] @ [S, 3V]`` split by columns, the skinning ``[V, J] @ [J, 12]`` by
rows; the only sum across vertices is the joint regression ``[J, V] @
[V, 3]``, summed over the group (:func:`~bodyfitting_torch.ops.comm.sum_over`).  Each rank
keeps its rows of every per-vertex array (:func:`shard_model_vertices`),
and ``body_model.forward`` on the sharded model gathers the skinned rows
where faces, selector ids and face landmarks index the whole mesh.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from bodyfitting_torch.models import body_model as bm

# model fields whose leading (or trailing) axis is the vertex axis
_VERTEX_AXIS0 = ("v_template", "lbs_weights")
_VERTEX_AXIS1 = ("J_regressor", "extra_joint_regressor")
# flattened [*, 3V] bases, vertex-major: split on the last axis
_VERTEX_FLAT = ("shapedirs", "posedirs", "expr_dirs", "kid_shape_dir")


def pad_model_vertices(model: bm.BodyModel, multiple: int) -> bm.BodyModel:
    """Pad the vertex axis to a multiple of ``multiple`` with inert rows:
    zero template rows, blend-shape columns, regressor columns and
    skinning-weight rows, so a pad vertex skins to exactly 0 and carries
    no gradient, and the joints are unchanged.  Faces, selector ids and
    landmark tables keep their indices.  Forward outputs gain ``V_pad -
    V`` trailing zero rows.  The arrays are the JAX function's, bit for
    bit."""
    V = model.v_template.shape[0]
    V_pad = -(-V // multiple) * multiple
    if V_pad == V:
        return model
    extra = V_pad - V

    def pad_rows(x):                       # [V, *] -> [V_pad, *]
        return torch.cat([x, x.new_zeros((extra,) + x.shape[1:])])

    def pad_cols(x):                       # [*, V] -> [*, V_pad]
        return torch.cat([x, x.new_zeros(x.shape[:-1] + (extra,))], -1)

    def pad_flat(x):                       # [*, 3V] -> [*, 3V_pad]
        lead = x.shape[:-1]
        u = x.reshape(lead + (V, 3))
        return torch.cat([u, u.new_zeros(lead + (extra, 3))],
                         -2).reshape(lead + (3 * V_pad,))

    updates = {}
    for names, pad in ((_VERTEX_AXIS0, pad_rows), (_VERTEX_AXIS1, pad_cols),
                       (_VERTEX_FLAT, pad_flat)):
        for name in names:
            if getattr(model, name) is not None:
                updates[name] = pad(getattr(model, name))
    return dataclasses.replace(model, **updates)


def make_tp_mesh(size=None) -> DeviceMesh:
    """A one-dimensional ``("tp",)`` mesh over the first ``size`` ranks
    of the initialised world (default: all of them)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "bodyfitting_torch.parallel.init_world() (or "
                           "start the program with torchrun) first")
    size = size or dist.get_world_size()
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(kind, torch.arange(size), mesh_dim_names=("tp",))


def shard_model_vertices(model: bm.BodyModel, mesh: DeviceMesh,
                         axis: str = "tp",
                         auto_pad: bool = True) -> bm.BodyModel:
    """This rank's rows of ``model``'s per-vertex arrays, with the group
    of ``mesh[axis]`` as the model's ``tp_group``.

    The vertex count must divide the axis size; with ``auto_pad`` any
    model (SMPL-X's V = 10,475 is odd) is first padded by
    :func:`pad_model_vertices`, and the forward's vertices then carry
    trailing zero rows.  Faces, selector ids and the other tables stay
    whole."""
    size = mesh.shape[mesh.mesh_dim_names.index(axis)]
    rank = mesh.get_local_rank(axis)
    if model.tp_group is not None:
        raise ValueError("the model is already vertex-sharded")
    if model.J_template is not None:
        raise ValueError("a joints reduction (reduce_for_joints) has no "
                         "vertex axis to shard; shard the full model")
    if model.v_template.shape[0] % size:
        if not auto_pad:
            raise ValueError(
                f"vertex count {model.v_template.shape[0]} must divide "
                f"mesh['{axis}'] = {size}; pad the model's vertex axis "
                f"(pad_model_vertices) or pass auto_pad=True")
        model = pad_model_vertices(model, size)
    n = model.v_template.shape[0] // size

    def local(name, x):
        if name in _VERTEX_AXIS0:
            x = x[rank * n:(rank + 1) * n]
        elif name in _VERTEX_AXIS1:
            x = x[..., rank * n:(rank + 1) * n]
        else:
            x = x[..., 3 * rank * n:3 * (rank + 1) * n]
        return x.contiguous().clone()

    updates = {name: local(name, getattr(model, name))
               for name in _VERTEX_AXIS0 + _VERTEX_AXIS1 + _VERTEX_FLAT
               if getattr(model, name) is not None}
    return dataclasses.replace(model, tp_group=mesh.get_group(axis),
                               **updates)


def replicate_params(params, mesh: DeviceMesh):
    """The fit or body parameters (a dataclass of tensors) broadcast from
    the mesh's first rank over the world, so every rank holds the same
    values."""
    src = int(mesh.mesh.reshape(-1)[0])

    def rep(x):
        if dataclasses.is_dataclass(x):
            return type(x)(**{f.name: rep(getattr(x, f.name))
                              for f in dataclasses.fields(x)})
        if not torch.is_tensor(x) or dist.get_world_size() == 1:
            return x
        x = x.detach().clone().contiguous()
        dist.broadcast(x, src)
        return x

    return rep(params)
