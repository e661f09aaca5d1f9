"""Fit-result parameter IO: the ``{smpl_type}_parameter.npy`` contract.

Counterpart of ``bodyfitting_tpu/io/params.py``.  Each frame's result is
saved as a pickled dict ``.npy`` of float32 arrays with the keys
vertices / joints / pose / betas / global_orient / faces (int32) /
global_transl / scale / full_pose (and displacement after SMPL+D), the
reference's schema that GeneBody tooling loads.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from bodyfitting_torch.io.obj import save_obj

PARAM_KEYS = (
    "vertices", "joints", "pose", "betas", "global_orient", "faces",
    "global_transl", "scale", "full_pose",
)


def _numpy(v) -> np.ndarray:
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def to_numpy_result(result: dict, faces) -> dict:
    """A fit's result (tensors or arrays) in the reference's schema."""
    out = {k: _numpy(v).astype(np.float32) for k, v in result.items()}
    out["faces"] = _numpy(faces).astype(np.int32)
    return out


def param_filename(smpl_type: str) -> str:
    return f"{smpl_type}_parameter.npy"


def save_params(path: str, result: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.save(path, result, allow_pickle=True)


def load_params(path: str) -> dict:
    return np.load(path, allow_pickle=True).item()


def save_fit_outputs(output_dir: str, smpl_type: str, result: dict, faces,
                     displacement: Optional[np.ndarray] = None) -> None:
    """Write ``{smpl_type}_parameter.npy`` and ``{smpl_type}.obj`` (and
    ``{smpl_type}+d.obj`` with ``displacement``) under ``output_dir``."""
    os.makedirs(output_dir, exist_ok=True)
    res = to_numpy_result(result, faces)
    save_params(os.path.join(output_dir, param_filename(smpl_type)), res)
    save_obj(os.path.join(output_dir, f"{smpl_type}.obj"), res["vertices"],
             res["faces"])
    if displacement is not None:
        save_obj(os.path.join(output_dir, f"{smpl_type}+d.obj"),
                 res["vertices"] + _numpy(displacement).astype(np.float32),
                 res["faces"])


def make_hmr_vec(pose, betas, cam_t, smpl_type: str) -> np.ndarray:
    """Pack (pose, betas, cam_t) into one float32 row vector ``[1, n]``:
    66 + 10 + 3 for SMPL-X, 72 + 10 + 3 for SMPL (the JAX package's
    ``io/params.py:make_hmr_vec``)."""
    n = 66 if smpl_type == "smplx" else 72
    return np.concatenate([
        _numpy(pose).astype(np.float32).reshape(1, n),
        _numpy(betas).astype(np.float32).reshape(1, 10),
        _numpy(cam_t).astype(np.float32).reshape(1, 3),
    ], axis=1)
