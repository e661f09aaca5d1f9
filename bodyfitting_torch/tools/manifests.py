"""Key and shape manifests of the released torch checkpoints.

Counterpart of ``bodyfitting_tpu/tools/manifests.py``.  Three families of
released weights load into the port's networks:

* SPIN HMR ``model_checkpoint.pt`` (``models/hmr.py``: ResNet-50 and the
  iterative-error-feedback head; its ``model`` dict);
* pytorch-openpose ``body_pose_model.pth`` / ``hand_pose_model.pth`` and
  the face net (``models/openpose.py``; flat layer-name keys);
* LBAM ``LBAM_NoBN_ParisStreetView.pth`` (``models/inpaint.py``).

Each ``expected_*`` function reads the key -> shape table a file must
hold from the port's own ``nn.Module`` (whose parameter names are the
files' keys), so the manifest cannot drift from the architecture, and
:func:`check_state_dict` reports missing, mis-shaped and extra keys
before anything is loaded.  The loaders call :func:`verify_or_raise` and
refuse a wrong file with that report.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

# SPIN's checkpoint also saves the mean-parameter buffers its HMR
# registers; the port reads the means from ``smpl_mean_params.npz``.
HMR_MEAN_BUFFERS = {"init_pose": (1, 144), "init_shape": (1, 10),
                    "init_cam": (1, 3)}


def expected_hmr_state_dict(net: nn.Module):
    """``(required, optional)`` key -> shape tables of the SPIN HMR
    checkpoint's ``model`` dict for ``net`` (a ``models.hmr.HMR``): every
    parameter and batch-norm statistic is required; batch norm's
    ``num_batches_tracked`` and the mean-parameter buffers are
    optional."""
    required, optional = {}, dict(HMR_MEAN_BUFFERS)
    for k, v in net.state_dict().items():
        if k.endswith("num_batches_tracked"):
            optional[k] = ()
        else:
            required[k] = tuple(v.shape)
    return required, optional


def expected_openpose_state_dict(net: nn.Module):
    """``(required, {})``: the key -> shape table of a released OpenPose
    file in its flat layer-name form, for the ``models.openpose`` net."""
    return {k: tuple(v.shape) for k, v in net.state_dict().items()}, {}


def expected_lbam_state_dict(net: nn.Module):
    """``(required, {})``: the key -> shape table of
    ``LBAM_NoBN_ParisStreetView.pth`` (the generator's own keys) for a
    ``models.inpaint.LBAM``."""
    return {k: tuple(v.shape) for k, v in net.state_dict().items()}, {}


def _shape_of(v):
    if torch.is_tensor(v):
        return tuple(v.shape)
    return tuple(np.asarray(v).shape)


def normalize_openpose_keys(state_dict: dict) -> dict:
    """Keys cut down to ``<layer>.<leaf>``: the released files are flat
    already; re-prefixed saves (``model0.conv1_1.weight``) become the same
    form."""
    return {".".join(k.split(".")[-2:]): v for k, v in state_dict.items()}


def check_state_dict(state_dict, required, optional=None):
    """A state dict's keys and shapes against a manifest: ``ok`` (no key
    missing, no shape wrong), ``missing`` (key -> shape), ``mismatched``
    (key -> (expected, actual)), ``extra`` (present, in neither table;
    ignored, as the reference's non-strict loads ignore them),
    ``n_required``, ``n_present``.  An optional key is checked for its
    shape when present, unless its shape is ``()``."""
    optional = optional or {}
    shapes = {k: _shape_of(v) for k, v in state_dict.items()}
    missing = {k: s for k, s in required.items() if k not in shapes}
    mismatched = {}
    for k, exp in required.items():
        if k in shapes and shapes[k] != tuple(exp):
            mismatched[k] = (tuple(exp), shapes[k])
    for k, exp in optional.items():
        if k in shapes and tuple(exp) and shapes[k] != tuple(exp):
            mismatched[k] = (tuple(exp), shapes[k])
    known = set(required) | set(optional)
    extra = sorted(k for k in shapes if k not in known)
    return {
        "ok": not missing and not mismatched,
        "missing": missing,
        "mismatched": mismatched,
        "extra": extra,
        "n_required": len(required),
        "n_present": len(required) - len(missing),
    }


def describe_report(report, what):
    """A failed (or passed) check as readable lines."""
    lines = [f"{what}: {report['n_present']}/{report['n_required']} "
             f"required tensors present"]
    for k, s in list(report["missing"].items())[:10]:
        lines.append(f"  missing  {k}  expected {s}")
    if len(report["missing"]) > 10:
        lines.append(f"  ... and {len(report['missing']) - 10} more missing")
    for k, (e, a) in list(report["mismatched"].items())[:10]:
        lines.append(f"  shape    {k}  expected {e}, got {a}")
    if len(report["mismatched"]) > 10:
        lines.append(
            f"  ... and {len(report['mismatched']) - 10} more mismatched")
    if report["extra"]:
        lines.append(f"  note: {len(report['extra'])} extra keys ignored "
                     f"(e.g. {report['extra'][:3]})")
    return "\n".join(lines)


def verify_or_raise(state_dict, required, optional, what):
    """``ValueError`` with the full report when the check fails; the
    report otherwise."""
    report = check_state_dict(state_dict, required, optional)
    if not report["ok"]:
        raise ValueError("checkpoint structure does not match the published "
                         + describe_report(report, what))
    return report
