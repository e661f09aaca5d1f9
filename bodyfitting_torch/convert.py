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
