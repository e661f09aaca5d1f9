"""Camera annotation IO: the GeneBody ``annots.npy`` contract.

Counterpart of ``bodyfitting_tpu/io/cameras.py``.  ``annots.npy`` is a
pickled dict ``{'cams': {'K': [...], 'RT': [...]}}`` with per-view
intrinsics and camera-to-world transforms.  The per-subject missing-view
table is the published dataset's list of camera outages.
"""

from __future__ import annotations

import numpy as np

from bodyfitting_torch.constants import GENEBODY_NUM_VIEWS

GENEBODY_MISSING_VIEWS = {
    "Tichinah_jervier": {32},
    "dannier": {32},
    "wuwenyan": {34, 36},
    "joseph_matanda": {39, 40, 42, 43, 44, 45, 46, 47},
}


def genebody_views(subject: str) -> list[int]:
    """The subject's camera ids, its outages left out."""
    missing = GENEBODY_MISSING_VIEWS.get(subject, set())
    return [v for v in range(GENEBODY_NUM_VIEWS) if v not in missing]


def load_annots(path: str):
    """``annots.npy`` -> ``(Ks [V, 3, 3], RTs [V, 4, 4])`` float32; 3x4
    transforms get their homogeneous row."""
    cams = np.load(path, allow_pickle=True).item()["cams"]
    Ks = np.asarray([np.asarray(k, np.float32) for k in cams["K"]])
    RTs = np.asarray([np.asarray(rt, np.float32) for rt in cams["RT"]])
    if RTs.shape[-2] == 3:
        pad = np.zeros(RTs.shape[:-2] + (1, 4), RTs.dtype)
        pad[..., 0, 3] = 1.0
        RTs = np.concatenate([RTs, pad], axis=-2)
    return Ks, RTs


def save_annots(path: str, Ks, RTs) -> None:
    np.save(path, {"cams": {"K": list(np.asarray(Ks)),
                            "RT": list(np.asarray(RTs))}}, allow_pickle=True)
