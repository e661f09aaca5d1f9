"""Hand one JAX-package object to the PyTorch port, through numpy."""

import dataclasses

import numpy as np


def arrays_of(obj) -> dict:
    """Every field of a JAX dataclass: arrays as numpy, the rest as is."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is not None and hasattr(v, "shape") and hasattr(v, "dtype"):
            v = np.asarray(v)
        out[f.name] = v
    return out


def torch_model(jax_model, dtype=None):
    from bodyfitting_torch.convert import body_model_from_numpy

    return body_model_from_numpy(arrays_of(jax_model), dtype=dtype,
                                 device="cpu")


def torch_prior(jax_prior, dtype=None):
    import torch

    from bodyfitting_torch.convert import gmm_prior_from_numpy

    a = arrays_of(jax_prior)
    dt = dtype or torch.from_numpy(np.array(a["means"])).dtype
    return gmm_prior_from_numpy(a["means"], a["precisions"],
                                a["log_nll_weights"], a["mean_pose"],
                                dtype=dt, device="cpu")


def torch_params(jax_params, batched=False):
    from bodyfitting_torch.convert import fit_params_from_numpy

    return fit_params_from_numpy(
        arrays_of(jax_params.body), np.asarray(jax_params.global_transl),
        np.asarray(jax_params.body_scale), batched=batched, device="cpu",
    )


def torch_obs(jax_obs, batched=False, dtype=None):
    from bodyfitting_torch.convert import observations_from_numpy

    fields = arrays_of(jax_obs)
    if fields.get("scan_volume") is not None:
        fields["scan_volume"] = arrays_of(fields["scan_volume"])
    return observations_from_numpy(fields, batched=batched, dtype=dtype,
                                   device="cpu")
