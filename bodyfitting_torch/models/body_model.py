"""SMPL / SMPL-X body models as batched PyTorch functions.

Counterpart of ``bodyfitting_tpu/models/body_model.py``.  The JAX module
evaluates one frame and ``vmap``s over frames; here every function takes a
leading frame axis ``B`` on the parameters (``BodyParams`` fields are
``[B, ...]``) and returns ``[B, ...]`` outputs.  The model arrays carry no
batch axis.

Host-side model preparation (the joints-only reductions, the synthetic
fixture) is numpy, as in the JAX package, so the same seed gives the same
arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from bodyfitting_torch.device import default_device
from bodyfitting_torch.ops.rotations import rodrigues


def smpl_to_openpose(
    model_type: str = "smplx",
    use_hands: bool = True,
    use_face: bool = True,
    use_face_contour: bool = False,
) -> np.ndarray:
    """Permutation of model joints into OpenPose BODY_25 (+hands, +face)
    keypoint order: the published coco25 index tables."""
    if model_type == "smpl":
        return np.array(
            [24, 12, 17, 19, 21, 16, 18, 20, 0, 2, 5, 8, 1, 4, 7,
             25, 26, 27, 28, 29, 30, 31, 32, 33, 34], dtype=np.int64)
    if model_type == "smplh":
        body = [52, 12, 17, 19, 21, 16, 18, 20, 0, 2, 5, 8, 1, 4, 7,
                53, 54, 55, 56, 57, 58, 59, 60, 61, 62]
        mapping = [np.array(body, dtype=np.int64)]
        if use_hands:
            mapping += [
                np.array([20, 34, 35, 36, 63, 22, 23, 24, 64, 25, 26, 27,
                          65, 31, 32, 33, 66, 28, 29, 30, 67], dtype=np.int64),
                np.array([21, 49, 50, 51, 68, 37, 38, 39, 69, 40, 41, 42,
                          70, 46, 47, 48, 71, 43, 44, 45, 72], dtype=np.int64),
            ]
        return np.concatenate(mapping)
    if model_type == "smplx":
        body = [55, 12, 17, 19, 21, 16, 18, 20, 0, 2, 5, 8, 1, 4, 7,
                56, 57, 58, 59, 60, 61, 62, 63, 64, 65]
        mapping = [np.array(body, dtype=np.int64)]
        if use_hands:
            mapping += [
                np.array([20, 37, 38, 39, 66, 25, 26, 27, 67, 28, 29, 30,
                          68, 34, 35, 36, 69, 31, 32, 33, 70], dtype=np.int64),
                np.array([21, 52, 53, 54, 71, 40, 41, 42, 72, 43, 44, 45,
                          73, 49, 50, 51, 74, 46, 47, 48, 75], dtype=np.int64),
            ]
        if use_face:
            mapping += [np.arange(76, 127 + 17 * use_face_contour,
                                  dtype=np.int64)]
        return np.concatenate(mapping)
    raise ValueError(f"unknown model type {model_type}")


@dataclasses.dataclass(frozen=True)
class BodyModel:
    """Body-model arrays (tensors on one device) plus static metadata.

    Same fields as the JAX ``BodyModel``; index tables are int64 here.
    """

    v_template: torch.Tensor          # [V, 3]
    shapedirs: torch.Tensor           # [S, 3V]
    posedirs: torch.Tensor            # [(J-1)*9, 3V]
    J_regressor: torch.Tensor         # [J, V]
    lbs_weights: torch.Tensor         # [V, J]
    faces: torch.Tensor               # [F, 3] int64
    expr_dirs: Optional[torch.Tensor]          # [E, 3V]
    hand_components_l: Optional[torch.Tensor]  # [C, 45]
    hand_components_r: Optional[torch.Tensor]  # [C, 45]
    hand_mean_l: Optional[torch.Tensor]        # [45]
    hand_mean_r: Optional[torch.Tensor]        # [45]
    lmk_faces_idx: Optional[torch.Tensor]      # [51]
    lmk_bary_coords: Optional[torch.Tensor]    # [51, 3]
    dyn_lmk_faces_idx: Optional[torch.Tensor]  # [79, 17]
    dyn_lmk_bary_coords: Optional[torch.Tensor]  # [79, 17, 3]
    extra_joint_regressor: Optional[torch.Tensor]  # [9, V]
    selector_ids: Optional[torch.Tensor]       # [21]
    joint_mapper: Optional[torch.Tensor]       # [M]
    kid_shape_dir: Optional[torch.Tensor]      # [3V]
    # folded joint regression (set by reduce_for_joints / reduce_for_rows)
    J_template: Optional[torch.Tensor] = None      # [J, 3]
    J_shapedirs: Optional[torch.Tensor] = None     # [S, J*3]
    J_exprdirs: Optional[torch.Tensor] = None      # [E, J*3]
    J_kid_dir: Optional[torch.Tensor] = None       # [J*3]
    model_type: str = "smpl"
    parents: tuple = ()
    neck_chain: tuple = ()
    num_betas: int = 10
    num_expressions: int = 0
    num_hand_pca: int = 6
    hand_use_pca: bool = True
    flat_hand_mean: bool = False
    use_face_contour: bool = False

    @property
    def num_verts(self) -> int:
        return self.v_template.shape[0]

    @property
    def num_joints(self) -> int:
        return self.J_regressor.shape[0]

    @property
    def num_body_joints(self) -> int:
        """Joints driven by ``body_pose`` (23 for SMPL, 21 otherwise)."""
        return 23 if self.model_type == "smpl" else 21

    @property
    def dtype(self) -> torch.dtype:
        return self.v_template.dtype

    @property
    def device(self) -> torch.device:
        return self.v_template.device


BODY_PARAM_FIELDS = (
    "betas", "global_orient", "body_pose", "expression", "jaw_pose",
    "leye_pose", "reye_pose", "left_hand_pose", "right_hand_pose",
)


@dataclasses.dataclass(frozen=True)
class BodyParams:
    """Optimisable body parameters, each with a leading frame axis."""

    betas: torch.Tensor            # [B, S]
    global_orient: torch.Tensor    # [B, 3]
    body_pose: torch.Tensor        # [B, 3 * num_body_joints]
    expression: torch.Tensor       # [B, E]
    jaw_pose: torch.Tensor         # [B, 3]
    leye_pose: torch.Tensor        # [B, 3]
    reye_pose: torch.Tensor        # [B, 3]
    left_hand_pose: torch.Tensor   # [B, C]
    right_hand_pose: torch.Tensor  # [B, C]

    @staticmethod
    def zeros(model: BodyModel, batch: int = 1) -> "BodyParams":
        c = model.num_hand_pca if model.hand_use_pca else 45
        sizes = dict(
            betas=model.num_betas, global_orient=3,
            body_pose=3 * model.num_body_joints,
            expression=model.num_expressions, jaw_pose=3, leye_pose=3,
            reye_pose=3, left_hand_pose=c, right_hand_pose=c,
        )
        return BodyParams(**{
            k: torch.zeros((batch, n), dtype=model.dtype, device=model.device)
            for k, n in sizes.items()
        })


@dataclasses.dataclass(frozen=True)
class BodyOutput:
    vertices: torch.Tensor     # [B, V, 3]
    joints: torch.Tensor       # [B, Jm, 3] mapped joints (OpenPose order)
    joints_raw: torch.Tensor   # skeleton + selector (+ landmark) joints
    full_pose: torch.Tensor    # [B, J*3]


def blend_shapes(coeffs: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """``[B, S]`` coefficients x ``[S, 3V]`` basis -> ``[B, V, 3]``."""
    out = torch.matmul(coeffs, dirs)
    return out.reshape(coeffs.shape[0], dirs.shape[-1] // 3, 3)


def vertices2joints(J_regressor: torch.Tensor,
                    verts: torch.Tensor) -> torch.Tensor:
    """Joints ``[B, J, 3]`` regressed from vertices ``[B, V, 3]``."""
    return torch.matmul(J_regressor, verts)


def _tree_levels(parents: tuple):
    """Joints grouped by depth in the kinematic tree.

    Returns ``(levels, inverse)``: ``levels`` is a list of
    ``(joint_ids, parent_positions)`` where ``parent_positions`` index the
    previous level's joints, and ``inverse`` maps joint id -> position in
    the concatenation of all levels.
    """
    J = len(parents)
    depth = [0] * J
    for j in range(1, J):
        depth[j] = depth[parents[j]] + 1
    levels, pos_in_level = [], {}
    for d in range(max(depth) + 1):
        ids = [j for j in range(J) if depth[j] == d]
        for k, j in enumerate(ids):
            pos_in_level[j] = k
        ppos = [pos_in_level[parents[j]] for j in ids] if d else []
        levels.append((ids, ppos))
    order = [j for ids, _ in levels for j in ids]
    inverse = np.argsort(np.asarray(order))
    return levels, inverse


def rigid_transform_chain(rot_mats: torch.Tensor, rest_joints: torch.Tensor,
                          parents: tuple):
    """Forward kinematics over the static kinematic tree.

    Args:
      rot_mats: ``[B, J, 3, 3]`` local joint rotations.
      rest_joints: ``[B, J, 3]`` rest-pose joint locations.

    Returns posed joints ``[B, J, 3]`` and the relative skinning
    transforms as ``[B, J, 3, 4]`` (world transform with the rest joint
    factored out).  Every world transform is ``world[parent] @ local``
    as in the JAX chain; the joints of one tree depth are multiplied in
    one batched matmul (about a dozen launches instead of 55).
    """
    B, J = rest_joints.shape[:2]
    par = list(parents[1:])
    rel = torch.cat(
        [rest_joints[:, :1], rest_joints[:, 1:] - rest_joints[:, par]], dim=1
    )
    top = torch.cat([rot_mats, rel[..., None]], dim=-1)          # [B,J,3,4]
    bottom = rot_mats.new_zeros((B, J, 1, 4))
    bottom[..., 0, 3] = 1.0
    local = torch.cat([top, bottom], dim=-2)                      # [B,J,4,4]

    levels, inverse = _tree_levels(tuple(parents))
    worlds = [local[:, levels[0][0]]]
    for ids, ppos in levels[1:]:
        worlds.append(torch.matmul(worlds[-1][:, ppos], local[:, ids]))
    world = torch.cat(worlds, dim=1)[:, inverse]                  # [B,J,4,4]

    posed_joints = world[:, :, :3, 3]
    correction = torch.einsum(
        "bjpq,bjq->bjp", world[:, :, :3, :3], rest_joints
    )
    rel_tf = torch.cat(
        [world[:, :, :3, :3], (posed_joints - correction)[..., None]], dim=-1
    )
    return posed_joints, rel_tf


def _full_pose(model: BodyModel, p: BodyParams) -> torch.Tensor:
    """The ``[B, J*3]`` axis-angle pose vector in smplx layout."""
    if model.model_type == "smpl":
        return torch.cat([p.global_orient, p.body_pose], dim=-1)

    def hand_aa(coeffs, components, mean):
        if model.hand_use_pca:
            aa = torch.matmul(coeffs, components[: coeffs.shape[-1]])
        else:
            aa = coeffs
        if not model.flat_hand_mean:
            aa = aa + mean
        return aa

    lhand = hand_aa(p.left_hand_pose, model.hand_components_l,
                    model.hand_mean_l)
    rhand = hand_aa(p.right_hand_pose, model.hand_components_r,
                    model.hand_mean_r)
    if model.model_type == "smplh":
        return torch.cat([p.global_orient, p.body_pose, lhand, rhand], -1)
    return torch.cat([
        p.global_orient, p.body_pose, p.jaw_pose, p.leye_pose, p.reye_pose,
        lhand, rhand,
    ], dim=-1)


def _face_landmarks(model: BodyModel, vertices: torch.Tensor,
                    full_pose_aa: torch.Tensor) -> torch.Tensor:
    """Static (51) + dynamic-contour (17) SMPL-X face landmarks
    ``[B, L, 3]``; the contour rows follow the head yaw."""
    B = vertices.shape[0]
    lmk_faces = model.lmk_faces_idx.expand(B, -1)
    lmk_bary = model.lmk_bary_coords.expand(B, -1, -1)
    if model.use_face_contour:
        chain = list(model.neck_chain)
        aa = full_pose_aa.reshape(B, -1, 3)[:, chain]
        rots = rodrigues(aa)                                    # [B,L,3,3]
        rel = rots[:, 0]
        for i in range(1, rots.shape[1]):
            rel = torch.matmul(rots[:, i], rel)
        y_angle = -torch.atan2(
            -rel[:, 2, 0], torch.sqrt(rel[:, 0, 0] ** 2 + rel[:, 1, 0] ** 2)
        ) * (180.0 / np.pi)
        y_rot = torch.round(torch.clamp(y_angle, max=39.0)).to(torch.int64)
        neg_vals = torch.where(y_rot < -39, 78, 39 - y_rot)
        idx = torch.where(y_rot < 0, neg_vals, y_rot)
        lmk_faces = torch.cat([lmk_faces, model.dyn_lmk_faces_idx[idx]], 1)
        lmk_bary = torch.cat([lmk_bary, model.dyn_lmk_bary_coords[idx]], 1)
    vids = model.faces[lmk_faces]                               # [B,L,3]
    bidx = torch.arange(B, device=vertices.device)[:, None, None]
    tri_verts = vertices[bidx, vids]                            # [B,L,3,3]
    return torch.einsum("blvc,blv->blc", tri_verts, lmk_bary)


def lbs(model: BodyModel, params: BodyParams):
    """Linear blend skinning.  Returns ``(vertices [B,V,3],
    skeleton_joints [B,J,3], full_pose [B,J*3])``."""
    full_pose_aa = _full_pose(model, params)
    B = full_pose_aa.shape[0]

    shape_betas = (
        params.betas[:, :-1] if model.kid_shape_dir is not None
        else params.betas
    )
    v_shaped = model.v_template + blend_shapes(shape_betas, model.shapedirs)
    if model.num_expressions and model.expr_dirs is not None:
        v_shaped = v_shaped + blend_shapes(params.expression, model.expr_dirs)
    if model.kid_shape_dir is not None:
        v_shaped = v_shaped + params.betas[:, -1:, None] * (
            model.kid_shape_dir.reshape(-1, 3)
        )

    if model.J_template is not None:
        rest_joints = model.J_template + blend_shapes(
            shape_betas, model.J_shapedirs
        )
        if model.num_expressions and model.J_exprdirs is not None:
            rest_joints = rest_joints + blend_shapes(
                params.expression, model.J_exprdirs
            )
        if model.J_kid_dir is not None:
            rest_joints = rest_joints + params.betas[:, -1:, None] * (
                model.J_kid_dir.reshape(-1, 3)
            )
    else:
        rest_joints = vertices2joints(model.J_regressor, v_shaped)

    rot_mats = rodrigues(full_pose_aa.reshape(B, -1, 3))        # [B,J,3,3]
    eye = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device)
    pose_feature = (rot_mats[:, 1:] - eye).reshape(B, -1)
    v_posed = v_shaped + blend_shapes(pose_feature, model.posedirs)

    posed_joints, rel_tf = rigid_transform_chain(
        rot_mats, rest_joints, model.parents
    )
    # Skinning as one matmul W @ A12 plus a 3x4 apply, as the JAX package
    # does when its fused-skinning kernel is off (its default).
    A12 = rel_tf.reshape(B, model.num_joints, 12)
    T = torch.matmul(model.lbs_weights, A12).reshape(B, -1, 3, 4)
    verts = torch.einsum("bvij,bvj->bvi", T[..., :3], v_posed) + T[..., 3]
    return verts, posed_joints, full_pose_aa


def forward(model: BodyModel, params: BodyParams) -> BodyOutput:
    """Full forward pass including auxiliary joints (batched over B)."""
    verts, skel_joints, full_pose_aa = lbs(model, params)
    joints = skel_joints
    if model.selector_ids is not None:
        joints = torch.cat([joints, verts[:, model.selector_ids]], dim=1)
    if model.model_type == "smplx" and model.lmk_faces_idx is not None:
        joints = torch.cat(
            [joints, _face_landmarks(model, verts, full_pose_aa)], dim=1
        )
    joints_raw = joints
    if model.model_type == "smpl" and model.extra_joint_regressor is not None:
        extra = vertices2joints(model.extra_joint_regressor, verts)
        joints = torch.cat([joints, extra], dim=1)
    if model.joint_mapper is not None:
        joints = joints[:, model.joint_mapper]
    return BodyOutput(vertices=verts, joints=joints, joints_raw=joints_raw,
                      full_pose=full_pose_aa)


def _neck_chain(parents: tuple, neck_idx: int = 12) -> tuple:
    chain, cur = [], neck_idx
    while cur != -1:
        chain.append(cur)
        cur = parents[cur]
    return tuple(chain)


# ---------------------------------------------------------------------------
# Joints-only model reductions (host-side, numpy)
# ---------------------------------------------------------------------------


def _np(t):
    return None if t is None else t.detach().cpu().numpy()


def reduce_for_rows(model: BodyModel, vertex_ids):
    """Joints reduction that also keeps the given full-model vertex rows.

    Returns ``(reduced_model, rows)`` with
    ``forward(reduced, p).vertices[:, rows] ==
    forward(model, p).vertices[:, vertex_ids]`` row for row.  The mask
    fit uses it so the keypoint and silhouette terms share one short
    forward.
    """
    vertex_ids = np.asarray(vertex_ids, np.int64)
    reduced, vids = _reduce_for_vertex_rows(model, vertex_ids)
    rows = np.searchsorted(vids, vertex_ids)
    return reduced, torch.as_tensor(rows, device=model.device)


def reduce_for_joints(model: BodyModel) -> BodyModel:
    """The model restricted to the vertex rows its joints depend on, with
    the joint regression folded into the bases (exact for the joints)."""
    reduced, _ = _reduce_for_vertex_rows(model, np.zeros((0,), np.int64))
    return reduced


def _reduce_for_vertex_rows(model: BodyModel, extra_vertex_ids):
    """Shared core of the reductions: keep the joint-reachable rows plus
    ``extra_vertex_ids``; returns ``(reduced_model, vids)`` with ``vids``
    the sorted kept row ids."""
    dev, dt = model.device, model.dtype
    faces = _np(model.faces)
    sel = _np(model.selector_ids) if model.selector_ids is not None \
        else np.zeros((0,), np.int64)

    fids = []
    if model.lmk_faces_idx is not None:
        fids.append(_np(model.lmk_faces_idx).ravel())
    if model.dyn_lmk_faces_idx is not None and model.use_face_contour:
        fids.append(_np(model.dyn_lmk_faces_idx).ravel())
    fids = (np.unique(np.concatenate(fids)) if fids
            else np.zeros((0,), np.int64))
    kept_faces = faces[fids]

    vids = np.unique(np.concatenate([
        sel.ravel(), kept_faces.ravel(),
        np.asarray(extra_vertex_ids, np.int64).ravel(),
    ])).astype(np.int64)
    vmap_ = np.full((model.num_verts,), -1, np.int64)
    vmap_[vids] = np.arange(len(vids))
    col3 = torch.as_tensor((vids[:, None] * 3 + np.arange(3)).ravel(),
                           device=dev)
    vids_t = torch.as_tensor(vids, device=dev)

    def cols(a):
        return None if a is None else a[:, col3]

    def as_index(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)

    def remap_faces(idx):
        idx = _np(idx)
        return as_index(np.searchsorted(fids, idx.ravel()).reshape(idx.shape))

    # fold the joint regression into the bases on the host in float64
    Jreg = _np(model.J_regressor).astype(np.float64)

    def fold(basis):
        if basis is None:
            return None
        b = _np(basis).astype(np.float64).reshape(
            basis.shape[0], model.num_verts, 3
        )
        return torch.as_tensor(
            np.einsum("svc,jv->sjc", b, Jreg).reshape(basis.shape[0], -1),
            dtype=dt, device=dev,
        )

    J_template = torch.as_tensor(
        Jreg @ _np(model.v_template).astype(np.float64), dtype=dt, device=dev
    )
    J_kid = None
    if model.kid_shape_dir is not None:
        kd = _np(model.kid_shape_dir).astype(np.float64).reshape(-1, 3)
        J_kid = torch.as_tensor((Jreg @ kd).reshape(-1), dtype=dt, device=dev)

    return dataclasses.replace(
        model,
        v_template=model.v_template[vids_t],
        shapedirs=cols(model.shapedirs),
        posedirs=cols(model.posedirs),
        expr_dirs=cols(model.expr_dirs),
        kid_shape_dir=(
            None if model.kid_shape_dir is None
            else model.kid_shape_dir.reshape(-1, 3)[vids_t].reshape(-1)
        ),
        lbs_weights=model.lbs_weights[vids_t],
        J_regressor=torch.zeros((model.num_joints, len(vids)), dtype=dt,
                                device=dev),
        faces=as_index(vmap_[kept_faces]),
        lmk_faces_idx=(
            None if model.lmk_faces_idx is None
            else remap_faces(model.lmk_faces_idx)
        ),
        # with the contour off the dynamic faces are not in `fids`, so a
        # remap would produce garbage indices: drop the tables instead
        dyn_lmk_faces_idx=(
            remap_faces(model.dyn_lmk_faces_idx)
            if model.dyn_lmk_faces_idx is not None and model.use_face_contour
            else None
        ),
        dyn_lmk_bary_coords=(
            model.dyn_lmk_bary_coords if model.use_face_contour else None
        ),
        selector_ids=(
            None if model.selector_ids is None else as_index(vmap_[sel])
        ),
        # dense [9, V] over posed vertices: not row-restrictable; zeros
        # keep the SPIN permutation shape-valid
        extra_joint_regressor=(
            None if model.extra_joint_regressor is None
            else torch.zeros((model.extra_joint_regressor.shape[0],
                              len(vids)), dtype=dt, device=dev)
        ),
        J_template=J_template,
        J_shapedirs=fold(model.shapedirs),
        J_exprdirs=fold(model.expr_dirs),
        J_kid_dir=J_kid,
    ), vids


# ---------------------------------------------------------------------------
# Synthetic fixtures (tests and runs without licensed assets)
# ---------------------------------------------------------------------------


def sphere_mesh(num_verts: int, rng):
    """A structured closed UV-sphere mesh squashed into a body-like
    ellipsoid, ``(verts [V, 3] float64, faces [F, 3] int32)``; the same
    RNG calls as the JAX fixture."""
    rows = max(int(np.sqrt(max(num_verts - 2, 8) / 2)), 2)
    cols = max((num_verts - 2) // rows, 3)
    th = np.pi * (np.arange(1, rows + 1)) / (rows + 1)
    ph = 2 * np.pi * np.arange(cols) / cols
    T, P = np.meshgrid(th, ph, indexing="ij")
    pts = np.stack(
        [np.sin(T) * np.cos(P), np.cos(T), np.sin(T) * np.sin(P)], -1
    ).reshape(-1, 3)
    top = np.array([[0.0, 1.0, 0.0]])
    bot = np.array([[0.0, -1.0, 0.0]])
    verts = np.concatenate([top, pts, bot], axis=0)
    verts = verts * np.array([0.35, 0.9, 0.25])
    wob = 0.08 * np.sin(5.0 * verts[:, 1] + 2.0) \
        + 0.05 * np.cos(4.0 * verts[:, 0] + 1.0)
    verts = verts * (1.0 + wob[:, None])
    verts = verts + rng.normal(scale=0.002, size=verts.shape)

    def vid(r, c):
        return 1 + r * cols + (c % cols)

    faces = []
    for c in range(cols):
        faces.append([0, vid(0, c + 1), vid(0, c)])
        faces.append([len(verts) - 1, vid(rows - 1, c), vid(rows - 1, c + 1)])
    for r in range(rows - 1):
        for c in range(cols):
            faces.append([vid(r, c), vid(r, c + 1), vid(r + 1, c)])
            faces.append([vid(r, c + 1), vid(r + 1, c + 1), vid(r + 1, c)])
    return verts.astype(np.float64), np.asarray(faces, np.int32)


def synthetic_model(
    model_type: str = "smpl",
    num_verts: int = 256,
    seed: int = 0,
    num_betas: int = 10,
    num_expressions: int = 10,
    num_hand_pca: int = 6,
    use_face_contour: bool = True,
    dtype=torch.float32,
    mesh: str = "random",
    device=None,
) -> BodyModel:
    """A small, structurally valid random body model.

    Makes the same numpy RNG calls as the JAX ``synthetic_model``, so the
    same seed gives the same arrays.  Runs on ``cuda`` unless ``device``
    says otherwise.
    """
    device = default_device(device)
    rng = np.random.default_rng(seed)
    if model_type == "smpl":
        J = 24
        parents = (-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14,
                   16, 17, 18, 19, 20, 21)
    elif model_type == "smplh":
        J = 52
        body = [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14,
                16, 17, 18, 19]
        lhand = [20, 22, 23, 20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35]
        rhand = [21, 37, 38, 21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50]
        parents = tuple(body + lhand + rhand)
    elif model_type == "smplx":
        J = 55
        body = [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14,
                16, 17, 18, 19]
        head_extra = [15, 15, 15]
        lhand = [20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 20, 37, 38]
        rhand = [21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52, 53]
        parents = tuple(body + head_extra + lhand + rhand)
    else:
        raise ValueError(model_type)

    if mesh == "sphere":
        v_template, sphere_faces = sphere_mesh(num_verts, rng)
        V = v_template.shape[0]
    else:
        V = num_verts
        v_template = rng.normal(scale=0.3, size=(V, 3))
        sphere_faces = None
    Jreg = rng.random((J, V)) ** 8
    Jreg /= Jreg.sum(axis=1, keepdims=True)
    rest_joints = Jreg @ v_template
    d2 = ((v_template[:, None] - rest_joints[None]) ** 2).sum(-1)
    W = np.exp(-d2 * 20.0)
    W /= W.sum(axis=1, keepdims=True)

    S = num_betas
    shapedirs = rng.normal(scale=0.01, size=(S, V * 3))
    posedirs = rng.normal(scale=0.001, size=((J - 1) * 9, V * 3))
    F = max(2 * V, 64)

    def distinct_tris(n, pool):
        a = rng.integers(0, pool, size=n)
        b = (a + 1 + rng.integers(0, pool - 1, size=n)) % pool
        c = (a + 1 + rng.integers(0, pool - 1, size=n)) % pool
        while True:
            clash = c == b
            if not clash.any():
                break
            c[clash] = (
                a[clash] + 1 + rng.integers(0, pool - 1, size=clash.sum())
            ) % pool
        return np.stack([a, b, c], axis=1).astype(np.int32)

    if sphere_faces is not None:
        faces = sphere_faces
        F = faces.shape[0]
    lmk_pool = min(max(F // 16, 8), 256)
    if sphere_faces is None:
        faces = distinct_tris(F, V)
        head_verts = max(V // 10, 8)
        faces[:lmk_pool] = distinct_tris(lmk_pool, head_verts)

    is_x = model_type == "smplx"
    has_hands = model_type in ("smplh", "smplx")
    E = num_expressions if is_x else 0

    def arr(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    def idx(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=device)

    lmk_faces = (
        rng.integers(0, lmk_pool, size=(51,)).astype(np.int32)
        if is_x else None
    )
    lmk_bary = None
    dyn_faces = dyn_bary = None
    if is_x:
        b = rng.random((51, 3))
        lmk_bary = b / b.sum(-1, keepdims=True)
        dyn_faces = rng.integers(0, lmk_pool, size=(79, 17)).astype(np.int32)
        db = rng.random((79, 17, 3))
        dyn_bary = db / db.sum(-1, keepdims=True)

    # keyword order below is the evaluation order of the JAX fixture's
    # constructor call, so the RNG stream is consumed identically
    expr_dirs = arr(rng.normal(scale=0.005, size=(E, V * 3))) if is_x else None
    hand_components_l = (arr(rng.normal(size=(num_hand_pca, 45)) * 0.5)
                         if has_hands else None)
    hand_components_r = (arr(rng.normal(size=(num_hand_pca, 45)) * 0.5)
                         if has_hands else None)
    hand_mean_l = arr(rng.normal(size=(45,)) * 0.05) if has_hands else None
    hand_mean_r = arr(rng.normal(size=(45,)) * 0.05) if has_hands else None
    selector_ids = idx(rng.integers(0, V, size=(21,)).astype(np.int32))
    return BodyModel(
        v_template=arr(v_template),
        shapedirs=arr(shapedirs),
        posedirs=arr(posedirs),
        J_regressor=arr(Jreg),
        lbs_weights=arr(W),
        faces=idx(faces),
        expr_dirs=expr_dirs,
        hand_components_l=hand_components_l,
        hand_components_r=hand_components_r,
        hand_mean_l=hand_mean_l,
        hand_mean_r=hand_mean_r,
        lmk_faces_idx=idx(lmk_faces) if is_x else None,
        lmk_bary_coords=arr(lmk_bary) if is_x else None,
        dyn_lmk_faces_idx=idx(dyn_faces) if is_x else None,
        dyn_lmk_bary_coords=arr(dyn_bary) if is_x else None,
        extra_joint_regressor=None,
        selector_ids=selector_ids,
        joint_mapper=(
            idx(smpl_to_openpose("smplx", use_face_contour=use_face_contour))
            if is_x else None
        ),
        kid_shape_dir=None,
        model_type=model_type,
        parents=parents,
        neck_chain=_neck_chain(parents) if is_x else (),
        num_betas=num_betas,
        num_expressions=E,
        num_hand_pca=num_hand_pca,
        flat_hand_mean=False,
        use_face_contour=use_face_contour and is_x,
    )


def spin_joint_mapper_for_smpl(model: BodyModel) -> BodyModel:
    """Attach the 49-joint SPIN permutation to a SMPL model, as the JAX
    package's apps load every SMPL model: joints = permute([45 joints ++ 9
    extra-regressed], SPIN_JOINT_PERMUTATION).  Without an
    ``extra_joint_regressor`` the 9 extra joints are zeros; only SPIN rows
    >= 25 read them, and the fitting losses use the first 25."""
    from bodyfitting_torch.constants import SPIN_JOINT_PERMUTATION

    extra = model.extra_joint_regressor
    if extra is None:
        extra = torch.zeros((9, model.num_verts), dtype=model.dtype,
                            device=model.device)
    return dataclasses.replace(
        model,
        joint_mapper=torch.as_tensor(SPIN_JOINT_PERMUTATION.astype(np.int64),
                                     device=model.device),
        extra_joint_regressor=extra,
    )
