"""Plain SMPL / SMPL-X forward: linear blend skinning with the published
joint tables, read straight from a model ``.npz`` (the arrays of the
released ``.pkl`` / ``.npz`` files).

Written from the papers (Loper et al. 2015; Pavlakos et al. 2019) and the
``smplx`` package's conventions: shape (and expression) blend shapes,
pose blend shapes on ``R - I`` of the 54 / 23 non-root joints, forward
kinematics over the kinematic tree, skinning, then the 21 vertex-picked
joints, the 51 static and 17 yaw-dependent face landmarks (SMPL-X) and
the OpenPose order.  The kinematic chain a tree depth at a time; no
kernels and no reductions: the reference the benchmark holds the program
to.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# The 21 vertex-picked joints (the smplx package's vertex_ids tables) in
# the VertexJointSelector order: 5 face, 6 feet, 10 fingertips.
SELECTOR_IDS = {
    "smpl": (332, 6260, 2800, 4071, 583, 3216, 3226, 3387, 6617, 6624,
             6787, 2746, 2319, 2445, 2556, 2673, 6191, 5782, 5905, 6016,
             6133),
    "smplx": (9120, 9929, 9448, 616, 6, 5770, 5780, 8846, 8463, 8474,
              8635, 5361, 4933, 5058, 5169, 5286, 8079, 7669, 7794, 7905,
              8022),
}

# SMPL-X joints (55 skeleton, 21 picked, 51 + 17 landmarks) in OpenPose
# order: BODY_25, both hands, 51 inner face points, 17 contour points.
SMPLX_TO_OPENPOSE = (
    [55, 12, 17, 19, 21, 16, 18, 20, 0, 2, 5, 8, 1, 4, 7,
     56, 57, 58, 59, 60, 61, 62, 63, 64, 65]
    + [20, 37, 38, 39, 66, 25, 26, 27, 67, 28, 29, 30, 68, 34, 35, 36, 69,
       31, 32, 33, 70]
    + [21, 52, 53, 54, 71, 40, 41, 42, 72, 43, 44, 45, 73, 49, 50, 51, 74,
       46, 47, 48, 75]
    + list(range(76, 144)))

# SMPL joints (24 skeleton, 21 picked) in SPIN's order, whose first 25
# rows are BODY_25 (the fits read no more of them).
SMPL_TO_BODY25 = (24, 12, 17, 19, 21, 16, 18, 20, 0, 2, 5, 8, 1, 4, 7,
                  25, 26, 27, 28, 29, 30, 31, 32, 33, 34)


@dataclasses.dataclass(frozen=True)
class Model:
    kind: str                        # "smpl" or "smplx"
    v_template: torch.Tensor         # [V, 3]
    shapedirs: torch.Tensor          # [V, 3, S]
    exprdirs: torch.Tensor | None    # [V, 3, E]
    posedirs: torch.Tensor           # [V, 3, (J-1)*9]
    J_regressor: torch.Tensor        # [J, V]
    weights: torch.Tensor            # [V, J]
    faces: torch.Tensor              # [F, 3] int64
    parents: tuple
    hand_components: tuple | None    # ([C, 45], [C, 45]) left, right
    hand_mean: tuple | None          # ([45], [45])
    lmk_faces: torch.Tensor | None   # [51]
    lmk_bary: torch.Tensor | None    # [51, 3]
    dyn_faces: torch.Tensor | None   # [79, 17]
    dyn_bary: torch.Tensor | None    # [79, 17, 3]

    @property
    def num_body_joints(self) -> int:
        return 23 if self.kind == "smpl" else 21


def load(path: str, kind: str, num_betas: int = 10,
         num_expressions: int = 10, num_hand_pca: int = 6,
         dtype=torch.float64, device="cpu") -> Model:
    """The model at ``path`` (an ``.npz``) in ``dtype`` on ``device``.
    SMPL-X keeps shape directions 0..9 and expression directions 300..309
    of its 400, as the released file lays them out."""
    data = np.load(path)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                               device=device)

    sd = np.asarray(data["shapedirs"], np.float64)
    is_x = kind == "smplx"
    parents = [int(p) for p in np.asarray(data["kintree_table"])[0]]
    parents[0] = -1
    return Model(
        kind=kind, v_template=t(data["v_template"]),
        shapedirs=t(sd[..., :num_betas]),
        exprdirs=t(sd[..., 300:300 + num_expressions]) if is_x else None,
        posedirs=t(data["posedirs"]), J_regressor=t(data["J_regressor"]),
        weights=t(data["weights"]),
        faces=torch.as_tensor(np.asarray(data["f"], np.int64), device=device),
        parents=tuple(parents),
        hand_components=(t(data["hands_componentsl"][:num_hand_pca]),
                         t(data["hands_componentsr"][:num_hand_pca]))
        if is_x else None,
        hand_mean=(t(data["hands_meanl"]), t(data["hands_meanr"]))
        if is_x else None,
        lmk_faces=torch.as_tensor(np.asarray(data["lmk_faces_idx"], np.int64),
                                  device=device) if is_x else None,
        lmk_bary=t(data["lmk_bary_coords"]) if is_x else None,
        dyn_faces=torch.as_tensor(
            np.asarray(data["dynamic_lmk_faces_idx"], np.int64),
            device=device) if is_x else None,
        dyn_bary=t(data["dynamic_lmk_bary_coords"]) if is_x else None,
    )


def rodrigues(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle ``[..., 3]`` to rotations ``[..., 3, 3]`` through the
    unit quaternion ``(cos t/2, sin t/2 aa / t)``, made unit, with ``t``
    the norm of ``aa + 1e-8`` (finite, with its gradient, at zero)."""
    t = torch.linalg.norm(aa + 1e-8, dim=-1, keepdim=True)
    q = torch.cat([torch.cos(t / 2), torch.sin(t / 2) * aa / t], -1)
    w, x, y, z = (q / torch.linalg.norm(q, dim=-1, keepdim=True)).unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(aa.shape[:-1] + (3, 3))


def full_pose(model: Model, p: dict) -> torch.Tensor:
    """The ``[B, J, 3]`` axis-angle pose of every joint."""
    parts = [p["global_orient"], p["body_pose"]]
    if model.kind == "smplx":
        hands = [p[k] @ comp + mean for k, comp, mean in zip(
            ("left_hand_pose", "right_hand_pose"), model.hand_components,
            model.hand_mean)]
        parts += [p["jaw_pose"], p["leye_pose"], p["reye_pose"]] + hands
    aa = torch.cat(parts, -1)
    return aa.reshape(aa.shape[0], -1, 3)


def yaw_degrees(model: Model, pose: torch.Tensor) -> torch.Tensor:
    """The head's yaw ``[B]`` in degrees along the neck chain, as the
    dynamic landmark table reads it (before its rounding)."""
    chain, j = [], 12
    while j != -1:
        chain.append(j)
        j = model.parents[j]
    rots = rodrigues(pose[:, chain])
    rel = rots[:, 0]
    for i in range(1, len(chain)):
        rel = rots[:, i] @ rel
    yaw = -torch.atan2(-rel[:, 2, 0], torch.sqrt(rel[:, 0, 0] ** 2
                                                + rel[:, 1, 0] ** 2))
    return yaw * (180.0 / np.pi)


def whole_degrees(yaw: torch.Tensor) -> torch.Tensor:
    """The whole degree ``[B]`` (int64) that picks the dynamic landmark
    row: the yaw clamped to at most 39 and rounded."""
    return torch.round(torch.clamp(yaw, max=39.0)).long()


def face_landmarks(model: Model, verts: torch.Tensor, pose: torch.Tensor,
                   deg: torch.Tensor | None = None) -> torch.Tensor:
    """The 51 static and 17 contour landmarks ``[B, 68, 3]``; the contour
    row follows the head's yaw along the neck chain, in whole degrees
    clamped to [-39, 39] (the released dynamic landmark table).  ``deg``
    forces the whole degree of each frame."""
    B = verts.shape[0]
    if deg is None:
        deg = whole_degrees(yaw_degrees(model, pose))
    row = torch.where(deg < 0, torch.where(deg < -39, 78, 39 - deg), deg)
    faces = torch.cat([model.lmk_faces.expand(B, -1), model.dyn_faces[row]],
                      1)
    bary = torch.cat([model.lmk_bary.expand(B, -1, -1), model.dyn_bary[row]],
                     1)
    tri = verts[torch.arange(B, device=verts.device)[:, None, None],
                model.faces[faces]]                       # [B, 68, 3, 3]
    return (tri * bary[..., None]).sum(2)


def forward(model: Model, p: dict, deg: torch.Tensor | None = None):
    """``(vertices [B, V, 3], joints [B, Jo, 3])`` of the parameters ``p``
    (``betas``, ``global_orient``, ``body_pose`` and, for SMPL-X,
    ``expression``, ``jaw_pose``, eye and hand poses); the joints in
    OpenPose order (BODY_25 for SMPL).  ``deg``: the face landmarks'
    whole degree of yaw, forced (:func:`face_landmarks`)."""
    B = p["betas"].shape[0]
    v = model.v_template + torch.einsum("bs,vcs->bvc", p["betas"],
                                        model.shapedirs)
    if model.kind == "smplx":
        v = v + torch.einsum("be,vce->bvc", p["expression"], model.exprdirs)
    rest = torch.einsum("jv,bvc->bjc", model.J_regressor, v)
    pose = full_pose(model, p)
    R = rodrigues(pose)                                       # [B, J, 3, 3]
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    feat = (R[:, 1:] - eye).reshape(B, -1)
    v = v + torch.einsum("bp,vcp->bvc", feat, model.posedirs)
    J = len(model.parents)
    par = [max(p, 0) for p in model.parents]
    local = torch.zeros((B, J, 4, 4), dtype=R.dtype, device=R.device)
    local[:, :, :3, :3] = R
    local[:, :, :3, 3] = rest - rest[:, par] * torch.as_tensor(
        [p >= 0 for p in model.parents], dtype=R.dtype,
        device=R.device)[:, None]
    local[:, :, 3, 3] = 1.0
    # world[j] = world[parent j] @ local[j], a tree depth at a time
    depth = [0] * J
    for j in range(1, J):
        depth[j] = depth[model.parents[j]] + 1
    world = local
    for d in range(1, max(depth) + 1):
        ids = [j for j in range(J) if depth[j] == d]
        world = world.index_copy(1, torch.as_tensor(ids, device=R.device),
                                 world[:, [par[j] for j in ids]]
                                 @ local[:, ids])
    posed_joints = world[:, :, :3, 3]
    rel = world.clone()
    rel[:, :, :3, 3] = posed_joints - torch.einsum(
        "bjpq,bjq->bjp", world[:, :, :3, :3], rest)
    T = torch.einsum("vj,bjpq->bvpq", model.weights, rel)
    verts = torch.einsum("bvpq,bvq->bvp", T[..., :3, :3], v) + T[..., :3, 3]
    sel = torch.as_tensor(SELECTOR_IDS[model.kind], device=verts.device)
    joints = torch.cat([posed_joints, verts[:, sel]], 1)
    if model.kind == "smplx":
        joints = torch.cat([joints, face_landmarks(model, verts, pose, deg)],
                           1)
        order = SMPLX_TO_OPENPOSE
    else:
        order = SMPL_TO_BODY25
    return verts, joints[:, list(order)]
