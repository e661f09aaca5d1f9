"""Carry models, priors, parameters and observations across from numpy.

The JAX package's objects are handed over as numpy arrays (a caller
converts each array field with ``np.asarray``), so this module imports
nothing of JAX.  Tests use it to give both packages one model, one prior,
one initial state and one set of observations.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from bodyfitting_torch.device import default_device
from bodyfitting_torch.fitting.smplify import FitParams, Observations
from bodyfitting_torch.losses.priors import (  # noqa: F401  (re-export)
    gmm_prior_from_arrays as gmm_prior_from_numpy,
)
from bodyfitting_torch.models.body_model import (
    BODY_PARAM_FIELDS,
    BodyModel,
    BodyParams,
)
from bodyfitting_torch.ops.sdf import DistanceVolume

# integer index tables of a BodyModel; every other array field is float
_INDEX_FIELDS = ("faces", "lmk_faces_idx", "dyn_lmk_faces_idx",
                 "selector_ids", "joint_mapper")


def _tensor(a, dtype, device):
    """``a`` as a tensor of ``dtype``, or of its own numpy dtype."""
    a = np.asarray(a)
    dt = dtype if dtype is not None else torch.from_numpy(
        np.zeros((), a.dtype)).dtype
    return torch.tensor(a, dtype=dt, device=device)


def body_model_from_numpy(fields: dict, dtype=None, device=None) -> BodyModel:
    """A :class:`BodyModel` from every field of a JAX ``BodyModel``: its
    arrays as numpy (None, or absent) and its static fields as they are.  Float
    arrays keep their dtype unless ``dtype`` is given; index tables become
    int64."""
    device = default_device(device)
    kw = {}
    for f in dataclasses.fields(BodyModel):
        if f.name not in fields and f.default is not dataclasses.MISSING:
            continue
        v = fields.get(f.name)     # an absent array field is None
        if f.name in _INDEX_FIELDS and v is not None:
            v = torch.tensor(np.asarray(v, np.int64), device=device)
        elif isinstance(v, np.ndarray):
            v = _tensor(v, dtype, device)
        kw[f.name] = v
    return BodyModel(**kw)


def fit_params_from_numpy(body: dict, global_transl, body_scale,
                          batched: bool = False, dtype=None,
                          device=None) -> FitParams:
    """:class:`FitParams` from a JAX ``FitParams``' arrays (``body``: the
    nine ``BodyParams`` fields).  Unbatched arrays (one frame) get a
    frame axis of 1."""
    device = default_device(device)

    def t(a):
        x = _tensor(a, dtype, device)
        return x if batched else x[None]

    return FitParams(
        body=BodyParams(**{k: t(body[k]) for k in BODY_PARAM_FIELDS}),
        global_transl=t(global_transl), body_scale=t(body_scale),
    )


def distance_volume_from_numpy(fields: dict, batched: bool = False,
                               dtype=None, device=None) -> DistanceVolume:
    """:class:`DistanceVolume` from a JAX ``DistanceVolume``'s four arrays
    (``dist``, ``face_idx``, ``origin``, ``spacing``); ``face_idx`` stays
    int32.  Unbatched arrays (one frame) get a frame axis of 1."""
    device = default_device(device)
    kw = {}
    for f in dataclasses.fields(DistanceVolume):
        x = _tensor(fields[f.name], None if f.name == "face_idx" else dtype,
                    device)
        kw[f.name] = x if batched else x[None]
    return DistanceVolume(**kw)


def lbam_state_dict_from_flax(variables: dict) -> dict:
    """The released LBAM checkpoint's state dict (numpy arrays by key) from
    the JAX package's Flax LBAM variables, handed over as nested dicts of
    numpy arrays: the inverse of ``models/inpaint.py:convert_lbam_torch``.
    Convolution kernels HWIO -> OIHW, transposed-convolution kernels
    (k, k, in, out) -> (in, out, k, k), gaussian gate scalars as they
    are."""
    params = variables.get("params", variables)
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
            return
        name, sub, leaf = path[0], path[1], path[-1]
        t = np.array(node, np.float32)
        if name.startswith("ec"):
            if sub == "gauss":
                out[f"{name}.conv.activationFuncG_A.{leaf}"] = t
            else:
                out[f"{name}.conv.{sub}.weight"] = t.transpose(3, 2, 0, 1)
        elif name.startswith("reverseConv"):
            if sub == "gauss":
                out[f"{name}.activationFuncG_A.{leaf}"] = t
            else:
                out[f"{name}.reverseMaskConv.weight"] = t.transpose(
                    3, 2, 0, 1)
        elif name == "dc7":
            out["dc7.weight"] = t.transpose(2, 3, 0, 1)
        elif name.startswith("dc"):
            out[f"{name}.conv.weight"] = t.transpose(2, 3, 0, 1)
        else:
            raise KeyError("/".join(path))

    for k, v in params.items():
        walk(v, (k,))
    return {k: np.array(v, order="C") for k, v in out.items()}


def hmr_state_dict_from_flax(variables: dict) -> dict:
    """The reference HMR checkpoint's state dict (numpy arrays by key)
    from the JAX package's Flax HMR variables (``params`` and
    ``batch_stats``, handed over as nested dicts of numpy arrays): the
    inverse of ``models/hmr.py:convert_torch_checkpoint``.  Convolution
    kernels HWIO -> OIHW, dense kernels ``[in, out]`` -> ``[out, in]``."""
    out = {}

    def prefix(mods):
        name = mods[0]
        if name.startswith("layer") and "_" in name:
            layer, block = name.split("_")
            sub = {"downsample_conv": "downsample.0",
                   "downsample_bn": "downsample.1"}.get(mods[1], mods[1])
            return f"{layer}.{block}.{sub}"
        return ".".join(mods)

    def walk(node, path, col):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,), col)
            return
        t = np.array(node, np.float32)
        p, leaf = prefix(path[:-1]), path[-1]
        if col == "batch_stats":
            key = "running_mean" if leaf == "mean" else "running_var"
            out[f"{p}.{key}"] = t
        elif leaf == "kernel":
            out[f"{p}.weight"] = (t.transpose(3, 2, 0, 1) if t.ndim == 4
                                  else t.T)
        elif leaf == "scale":
            out[f"{p}.weight"] = t
        else:
            out[f"{p}.bias"] = t

    for col in ("params", "batch_stats"):
        walk(variables.get(col, {}), (), col)
    return {k: np.array(v, order="C") for k, v in out.items()}


def openpose_state_dict_from_flax(variables: dict) -> dict:
    """A released OpenPose file's flat state dict (numpy arrays by key)
    from the JAX package's Flax body, hand or face variables (handed over
    as nested dicts of numpy arrays): the inverse of
    ``models/openpose.py:convert_openpose_torch``.  Kernels HWIO -> OIHW."""
    out = {}
    for layer, mods in variables.get("params", variables).items():
        conv = mods["conv"]
        out[f"{layer}.weight"] = np.array(
            np.asarray(conv["kernel"], np.float32).transpose(3, 2, 0, 1),
            order="C")
        out[f"{layer}.bias"] = np.array(conv["bias"], np.float32)
    return out


def observations_from_numpy(fields: dict, batched: bool = False,
                            dtype=None, device=None) -> Observations:
    """:class:`Observations` from a JAX ``Observations``' array fields
    (absent or None fields stay None).  ``scan_faces`` becomes int64 and
    ``scan_volume`` is a dict of the volume's arrays (see
    :func:`distance_volume_from_numpy`).  Unbatched arrays (one frame) get
    a frame axis of 1."""
    device = default_device(device)
    kw = {}
    for f in dataclasses.fields(Observations):
        v: Optional[np.ndarray] = fields.get(f.name)
        if v is None:
            continue
        if f.name == "scan_volume":
            kw[f.name] = distance_volume_from_numpy(v, batched, dtype, device)
            continue
        if f.name == "scan_faces":
            x = torch.tensor(np.asarray(v, np.int64), device=device)
        else:
            x = _tensor(v, dtype, device)
        kw[f.name] = x if batched else x[None]
    return Observations(**kw)
