"""The staged SMPLify optimizer, batched over frames.

Counterpart of ``bodyfitting_tpu/fitting/smplify.py``.  The JAX package
runs one frame's fit as a ``lax.scan`` and ``vmap``s it over frames; here
every tensor carries a leading frame axis and one Python loop runs the
Adam steps for all frames at once.  Per-frame gradients come from the
gradient of ``loss.sum()`` over frames, which is exact: frames share no
parameters.

Behaviours kept from the JAX package:
  * per-group Adam learning rates: ``transl_lr`` for global translation
    and scale, ``step_size`` for everything else; jaw pose and expression
    are frozen unless asked for (they get a zero learning rate there and
    no update here, which gives the same parameters);
  * staging: the mask term switches on for ``step > num_iters //
    stage_gate_den``, weighted ``mask_weight``;
  * mask-only fits run one reduced model that keeps the joint rows and
    the every-4th vertex rows the silhouette term reads
    (:func:`loss_models`);
  * scan fits (``use_mesh``) add the point-to-scan term after the gate,
    through the distance volume (``mesh_loss_impl="sdf"``) or the exact
    nearest-point query (``"exact"``), and with ``displacement`` run the
    SMPL+D stage after the body fit.  Each frame of a batch has its own
    scan, height, constant scale and distance volume (the JAX package's
    ``vmap`` of the one-scan fit); the scans of a batch have one shape.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from bodyfitting_torch.losses.keypoints import multiview_keypoint_loss
from bodyfitting_torch.losses.mesh import (
    compute_face_normals,
    compute_vertex_normals,
    normal_laplacian_smoothness,
    normal_loss,
    point_cloud_loss,
)
from bodyfitting_torch.losses.silhouette import (
    mask_crops_bits,
    silhouette_loss,
)
from bodyfitting_torch.models import body_model as bm
from bodyfitting_torch.ops import sdf
from bodyfitting_torch.ops.nearest import nearest_points

MESH_LOSS_IMPLS = ("sdf", "exact")


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """Static fitting configuration: the JAX ``FitConfig``'s fields and
    defaults.  ``view_chunk`` sums the keypoint term over blocks of views
    here too.  ``remat_forward`` and ``scan_unroll`` choose how XLA
    compiles the JAX fit and have no counterpart here: each raises when
    set away from its default, rather than being ignored.
    ``mesh_loss_impl`` is ``"sdf"`` (the distance volume, when the
    observations carry one) or ``"exact"`` (the nearest-point query every
    step); anything else raises."""

    num_iters: int = 600
    step_size: float = 1e-2
    transl_lr: float = 0.1
    use_mask: bool = False
    use_mesh: bool = False
    displacement: bool = False
    optimize_jaw: bool = False
    optimize_expression: bool = False
    imsize: float = 512.0
    sigma: float = 100.0
    pose_prior_weight: float = 4.78
    angle_prior_weight: float = 15.2
    shape_prior_weight: float = 5.0
    mask_weight: float = 5.0
    pc_weight: float = 5.0
    disp_lr: float = 5e-2
    stage_gate_den: int = 3
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    mesh_loss_impl: str = "sdf"
    remat_forward: bool = False
    reduce_joints_only: bool = True
    view_chunk: int = 0
    mask_point_order: str = "height"
    mask_height_axis: int = -1
    scan_unroll: int = 1

    def __post_init__(self):
        if self.remat_forward or self.scan_unroll != 1:
            raise ValueError(
                "remat_forward and scan_unroll are JAX compilation options "
                "with no counterpart in the port; leave them at their "
                "defaults")
        if self.mesh_loss_impl not in MESH_LOSS_IMPLS:
            raise ValueError(f"mesh_loss_impl must be one of "
                             f"{MESH_LOSS_IMPLS}, got {self.mesh_loss_impl!r}")


@dataclasses.dataclass(frozen=True)
class FitParams:
    """Everything the optimizer moves, each with a leading frame axis."""

    body: bm.BodyParams
    global_transl: torch.Tensor    # [B, 3]
    body_scale: torch.Tensor       # [B, 1]

    @staticmethod
    def init(
        model: bm.BodyModel,
        init_betas: Optional[torch.Tensor] = None,
        init_global_orient: Optional[torch.Tensor] = None,
        init_body_pose: Optional[torch.Tensor] = None,
        batch: int = 1,
        device=None,
    ) -> "FitParams":
        """Zero pose, unit scale, no translation; given init arrays are
        ``[B, n]`` (or ``[n]``, broadcast over the ``batch`` frames).  On
        ``device``, by default the model's."""
        device = device or model.device
        body = bm.BodyParams.zeros(model, batch, device)
        for name, val in (("betas", init_betas),
                          ("global_orient", init_global_orient),
                          ("body_pose", init_body_pose)):
            if val is not None:
                val = torch.as_tensor(val, dtype=model.dtype, device=device)
                body = dataclasses.replace(
                    body, **{name: val.expand(batch, -1).clone()}
                )
        return FitParams(
            body=body,
            global_transl=torch.zeros((batch, 3), dtype=model.dtype,
                                      device=device),
            body_scale=torch.ones((batch, 1), dtype=model.dtype,
                                  device=device),
        )

    def tensors(self) -> list:
        """The parameter tensors in a fixed order (body fields first)."""
        return [getattr(self.body, f) for f in bm.BODY_PARAM_FIELDS] + [
            self.global_transl, self.body_scale,
        ]

    @staticmethod
    def from_tensors(ts) -> "FitParams":
        n = len(bm.BODY_PARAM_FIELDS)
        return FitParams(
            body=bm.BodyParams(**dict(zip(bm.BODY_PARAM_FIELDS, ts[:n]))),
            global_transl=ts[n], body_scale=ts[n + 1],
        )


@dataclasses.dataclass(frozen=True)
class Observations:
    """Observed data with a leading frame axis ``B`` (pad views as needed).

    The scan fields (``use_mesh``) carry the frame axis too, one scan a
    frame.  ``scan_volume`` is an :class:`ops.sdf.DistanceVolume` whose
    fields have the frame axis.
    """

    w2cs: torch.Tensor                     # [B, Vw, 4, 4]
    Ks: torch.Tensor                       # [B, Vw, 3, 3]
    keypoints: torch.Tensor                # [B, Vw, K, 3]
    view_mask: torch.Tensor                # [B, Vw]
    constant_scale: torch.Tensor           # [B]
    num_views_used: Optional[torch.Tensor] = None   # [B]
    masks: Optional[torch.Tensor] = None            # [B, Vm, H, W]
    mask_w2cs: Optional[torch.Tensor] = None        # [B, Vm, 4, 4]
    mask_Ks: Optional[torch.Tensor] = None          # [B, Vm, 3, 3]
    contours: Optional[torch.Tensor] = None         # [B, Vm, P, 2]
    contour_valid: Optional[torch.Tensor] = None    # [B, Vm, P]
    mask_crops: Optional[torch.Tensor] = None       # [B, Vm, Hc, Wc]
    mask_crop_origins: Optional[torch.Tensor] = None  # [B, Vm, 2]
    mask_view_valid: Optional[torch.Tensor] = None  # [B, Vm]
    scan_verts: Optional[torch.Tensor] = None       # [B, Vs, 3]
    scan_faces: Optional[torch.Tensor] = None       # [B, Fs, 3] int64
    scan_height: Optional[torch.Tensor] = None      # [B]
    scan_volume: Optional[sdf.DistanceVolume] = None


def concat_frames(items):
    """Concatenate dataclasses of ``[1, ...]`` (or ``[b, ...]``) tensors
    along the frame axis; None fields must be None in every item, and a
    field must have one shape past the frame axis in every item (a batch
    of scans is a batch of equal-shape scans, as ``jnp.stack`` needs in
    the JAX package): anything else raises ``ValueError`` naming it."""
    first = items[0]
    fields = {}
    for f in dataclasses.fields(first):
        vals = [getattr(it, f.name) for it in items]
        if dataclasses.is_dataclass(vals[0]):
            fields[f.name] = concat_frames(vals)
        elif vals[0] is None:
            if any(v is not None for v in vals):
                raise ValueError(f"field {f.name} is None in some frames only")
            fields[f.name] = None
        else:
            shapes = sorted({tuple(v.shape[1:]) for v in vals})
            if len(shapes) > 1:
                raise ValueError(
                    f"frames of different shapes cannot be batched: field "
                    f"{f.name} has shapes {shapes} past the frame axis (pad "
                    f"them to one shape, or fit them apart)")
            fields[f.name] = torch.cat(vals, dim=0)
    return type(first)(**fields)


def to_device(item, device):
    """A dataclass of tensors (:class:`Observations`, :class:`FitParams`,
    nested ones included) with every tensor on ``device``.  Host tensors
    bound for a CUDA device are pinned first, so their copies run
    asynchronously on the current stream."""
    device = torch.device(device)
    fields = {}
    for f in dataclasses.fields(item):
        v = getattr(item, f.name)
        if dataclasses.is_dataclass(v):
            v = to_device(v, device)
        elif torch.is_tensor(v) and v.device != device:
            if device.type == "cuda" and v.device.type == "cpu":
                v = v.pin_memory()
            v = v.to(device, non_blocking=True)
        fields[f.name] = v
    return type(item)(**fields)


def _body_pose69(model: bm.BodyModel, body_pose: torch.Tensor) -> torch.Tensor:
    """SMPL-X's 63-dim body pose zero-padded to the prior's 69 dims."""
    if body_pose.shape[-1] == 69:
        return body_pose
    pad = body_pose.new_zeros(body_pose.shape[:-1] + (69 - body_pose.shape[-1],))
    return torch.cat([body_pose, pad], dim=-1)


class Adam:
    """Adam exactly as ``optax.scale_by_adam`` followed by the JAX
    package's per-group ``-lr * update`` (``smplify._make_optimizer``),
    updating the parameter tensors in place.  A group with learning rate
    0 is frozen: it and its moments are skipped, which leaves it where
    the JAX update ``p + (-0 * u)`` leaves it."""

    def __init__(self, params: list, lrs: list, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params = params
        self.lrs = lrs
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: list) -> None:
        self.count += 1
        p0 = self.params[0]
        # decay ** count in the working dtype, as optax computes it
        b1c = 1 - torch.tensor(self.b1, dtype=p0.dtype) ** self.count
        b2c = 1 - torch.tensor(self.b2, dtype=p0.dtype) ** self.count
        b1c, b2c = b1c.to(p0.device), b2c.to(p0.device)
        for p, g, mu, nu, lr in zip(self.params, grads, self.mu, self.nu,
                                    self.lrs):
            if lr == 0.0:
                continue
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            upd = (mu / b1c) / (torch.sqrt(nu / b2c) + self.eps)
            p.add_(-lr * upd)


def make_optimizer(config: FitConfig, params: FitParams) -> Adam:
    """Adam over ``params.tensors()`` with the per-group learning rates."""
    lrs = []
    for f in bm.BODY_PARAM_FIELDS:
        frozen = ((f == "jaw_pose" and not config.optimize_jaw)
                  or (f == "expression" and not config.optimize_expression))
        lrs.append(0.0 if frozen else config.step_size)
    lrs += [config.transl_lr, config.transl_lr]
    return Adam(params.tensors(), lrs, config.adam_b1, config.adam_b2)


def fit_loss(
    model: bm.BodyModel,
    config: FitConfig,
    params: FitParams,
    obs: Observations,
    step: int,
    pose_prior_fn,
    joints_model: Optional[bm.BodyModel] = None,
    mask_vertex_rows: Optional[torch.Tensor] = None,
    view_group=None,
):
    """Total staged loss per frame ``[B]`` at iteration ``step``, and a
    dict of per-frame terms.

    ``joints_model`` serves the keypoint term when given (the full
    forward then runs only for the mask term); ``mask_vertex_rows``
    marks ``model`` as a merged reduction whose rows hold the strided
    vertices the silhouette term reads (see :func:`loss_models`).
    ``view_group``: the keypoint views are split over this process group
    (:func:`~bodyfitting_torch.losses.keypoints.multiview_keypoint_loss`).
    """
    jm = joints_model if joints_model is not None else model
    out = bm.forward(jm, params.body)
    scale = params.body_scale * obs.constant_scale[:, None]      # [B, 1]
    transl = params.global_transl[:, None, :]
    model_joints = (out.joints + transl) * scale[:, :, None]

    total, terms = multiview_keypoint_loss(
        obs.w2cs, obs.Ks, obs.keypoints, obs.view_mask, model_joints,
        _body_pose69(model, params.body.body_pose), params.body.betas,
        pose_prior_fn,
        imsize=config.imsize, sigma=config.sigma,
        pose_prior_weight=config.pose_prior_weight,
        angle_prior_weight=config.angle_prior_weight,
        shape_prior_weight=config.shape_prior_weight,
        use_hand_face=model.model_type == "smplx",
        num_views_used=obs.num_views_used,
        view_chunk=config.view_chunk,
        view_group=view_group,
    )

    if not (config.use_mask or config.use_mesh):
        return total, terms
    mask_l = pc_l = torch.zeros_like(total)
    # the full-vertex forward runs only after the gate (JAX's lax.cond)
    if step > config.num_iters // config.stage_gate_den:
        stride = 4                          # reference loss.py:94 [::4]
        if mask_vertex_rows is not None:
            verts = out.vertices[:, mask_vertex_rows]
            stride = 1
        elif joints_model is None:
            verts = out.vertices
        else:
            verts = bm.forward(model, params.body).vertices
        verts = (verts + transl) * scale[:, :, None]
        if config.use_mask:
            mask_l = silhouette_loss(
                obs.contours, obs.contour_valid, obs.masks,
                obs.mask_w2cs, obs.mask_Ks, verts,
                imsize=config.imsize, vertex_stride=stride,
                mask_crops=obs.mask_crops,
                mask_crop_origins=obs.mask_crop_origins,
                mask_view_valid=obs.mask_view_valid,
                full_hw=(int(config.imsize), int(config.imsize)),
            )
        if config.use_mesh:
            pcs = []
            for b, (scan_verts, scan_faces, height, volume) in enumerate(
                    scan_frames(obs)):
                if config.mesh_loss_impl == "sdf" and volume is not None:
                    pc = sdf.point_cloud_loss_sdf(verts[b], volume)
                else:
                    pc = point_cloud_loss(verts[b], scan_verts, scan_faces)
                # reference: / scan_height * imsize (smplify.py:206)
                pcs.append(pc / height * config.imsize)
            pc_l = torch.stack(pcs)
    if config.use_mask:
        total = total + config.mask_weight * mask_l
        terms["mask_loss"] = mask_l
    if config.use_mesh:
        total = total + config.pc_weight * pc_l
        terms["pc_loss"] = pc_l
    return total, terms


def scan_frames(obs: Observations) -> list:
    """Each frame's ``(scan_verts, scan_faces, scan_height, scan_volume)``
    without the frame axis; the volume is None when the observations
    carry none.  Observations without a scan raise."""
    if obs.scan_verts is None:
        raise ValueError("use_mesh needs observations with a scan (pass "
                         "scan_verts and scan_faces to build_observations)")
    vol = obs.scan_volume
    out = []
    for b in range(obs.scan_verts.shape[0]):
        vb = None
        if vol is not None:
            vb = sdf.DistanceVolume(dist=vol.dist[b], face_idx=vol.face_idx[b],
                                    origin=vol.origin[b],
                                    spacing=vol.spacing[b])
        out.append((obs.scan_verts[b], obs.scan_faces[b], obs.scan_height[b],
                    vb))
    return out


def loss_models(model: bm.BodyModel, config: FitConfig):
    """``(loss_model, joints_model, mask_rows)`` as the JAX package picks
    them: with ``reduce_joints_only``, keypoint-only fits run the
    joints-reduced model; mask fits one reduced model that also keeps
    the every-4th vertex rows (ordered by height for
    ``mask_point_order="height"``), indexed by ``mask_rows``; scan fits
    the full model for vertices and the joints-reduced one for
    keypoints."""
    if not config.reduce_joints_only:
        return model, None, None
    if config.use_mesh:
        return model, bm.reduce_for_joints(model), None
    if config.use_mask:
        ids = np.arange(0, model.num_verts, 4)
        if config.mask_point_order == "height":
            vt = model.v_template.detach().cpu().numpy()[ids]
            ax = config.mask_height_axis
            if ax < 0:
                ax = int(np.argmax(vt.max(0) - vt.min(0)))
            ids = ids[np.argsort(vt[:, ax], kind="stable")]
        loss_model, rows = bm.reduce_for_rows(model, ids)
        return loss_model, None, rows
    return bm.reduce_for_joints(model), None, None


def step_observations(obs: Observations) -> Observations:
    """``obs`` as every step of a fit reads it: the mask crops as a bit
    mask (:func:`~bodyfitting_torch.losses.silhouette.mask_crops_bits`),
    made once a fit.  ``Observations`` keep f32 crops, as the JAX
    package's do."""
    if obs.mask_crops is None:
        return obs
    return dataclasses.replace(obs,
                               mask_crops=mask_crops_bits(obs.mask_crops))


def make_step_fn(model, config: FitConfig, obs: Observations,
                 pose_prior_fn, opt: Adam, view_group=None):
    """One Adam step, shared by every entry point: ``step_fn(step)``
    updates ``opt.params`` in place and returns the per-frame loss
    ``[B]`` before the update (detached).  ``view_group``: as in
    :func:`fit_loss`."""
    loss_model, joints_model, mask_rows = loss_models(model, config)
    obs = step_observations(obs)
    leaves = opt.params

    def step_fn(step: int) -> torch.Tensor:
        for p in leaves:
            p.requires_grad_(True)
        params = FitParams.from_tensors(leaves)
        loss, _ = fit_loss(loss_model, config, params, obs, step,
                           pose_prior_fn, joints_model=joints_model,
                           mask_vertex_rows=mask_rows, view_group=view_group)
        grads = torch.autograd.grad(loss.sum(), leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        for p in leaves:
            p.requires_grad_(False)
        opt.step(grads)
        return loss.detach()

    return step_fn


def fit(model: bm.BodyModel, config: FitConfig, obs: Observations,
        init: FitParams, pose_prior_fn, view_group=None):
    """Run the staged SMPLify optimization for a batch of frames.

    Returns ``(final FitParams, result dict, losses [B, num_iters])``;
    ``init`` is not modified.  Runs where ``model``'s tensors are.  A
    scan fit with ``displacement`` then runs the SMPL+D stage on the
    detached body vertices: ``result["displacement"]`` is ``[B, V, 3]``
    and the losses are ``[B, 2 num_iters]``, the body trace followed by
    the displacement trace.  ``view_group``: the keypoint views are split
    over this process group (:func:`fit_loss`).
    """
    if config.use_mesh:
        scan_frames(obs)                    # every frame has a scan
    params = FitParams.from_tensors([t.detach().clone()
                                     for t in init.tensors()])
    opt = make_optimizer(config, params)
    step_fn = make_step_fn(model, config, obs, pose_prior_fn, opt,
                           view_group)
    losses = [step_fn(i) for i in range(config.num_iters)]
    with torch.no_grad():
        result = fit_result(model, params, obs)
    losses = torch.stack(losses, dim=1)
    if config.displacement and config.use_mesh:
        disp, disp_losses = fit_displacement(
            model, config, obs, result["vertices"].detach())
        result["displacement"] = disp
        losses = torch.cat([losses, disp_losses], dim=1)
    return params, result, losses


def fit_result(model, params: FitParams, obs: Observations) -> dict:
    """The reference's output dict from the final parameters."""
    out = bm.forward(model, params.body)
    scale = (params.body_scale * obs.constant_scale[:, None])[:, :, None]
    transl = params.global_transl[:, None, :]
    return {
        "vertices": (out.vertices + transl) * scale,
        "joints": (out.joints + transl) * scale,
        "pose": params.body.body_pose,
        "betas": params.body.betas,
        "global_orient": params.body.global_orient,
        "global_transl": params.global_transl * params.body_scale,
        "scale": params.body_scale,
        "full_pose": out.full_pose,
    }


def fit_displacement(model: bm.BodyModel, config: FitConfig,
                     obs: Observations, body_vertices: torch.Tensor):
    """Stage 2, SMPL+D: per-vertex displacements of the fitted bodies
    ``[B, V, 3]``, each fitted to its frame's scan.  Returns
    ``(displacement [B, V, 3], losses [B, num_iters])``, each loss taken
    before its step's update."""
    disp_loss, opt, disp = displacement_problem(model, config, obs,
                                                body_vertices)
    losses = []
    for _ in range(config.num_iters):
        disp.requires_grad_(True)
        loss = disp_loss(disp)
        (grad,) = torch.autograd.grad(loss.sum(), [disp])
        disp.requires_grad_(False)
        opt.step([grad])
        losses.append(loss.detach())
    return disp, torch.stack(losses, dim=1)


def displacement_problem(model: bm.BodyModel, config: FitConfig,
                         obs: Observations, body_vertices: torch.Tensor):
    """The displacement stage as ``(loss_fn, optimizer, init)``: for each
    frame ``b``, the point-to-scan, normal and normal-smoothness terms on
    ``body_vertices[b] + disp[b]`` against frame ``b``'s scan
    (``loss_fn(disp [B, V, 3])`` gives ``[B]``), and Adam at ``disp_lr``
    (``optax.adam``: ``scale_by_adam``, eps 1e-8, then ``-lr``) over a
    displacement ``[B, V, 3]`` that starts at zero and is updated in
    place.  Adam is elementwise, so the batch's frames step as apart."""
    faces = model.faces
    use_sdf = config.mesh_loss_impl == "sdf"
    scans = []
    for b, (scan_verts, scan_faces, _, volume) in enumerate(scan_frames(obs)):
        scans.append((scan_verts, scan_faces, volume,
                      compute_face_normals(scan_verts, scan_faces),
                      obs.constant_scale[b]))

    def frame_loss(deformed, scan):
        scan_verts, scan_faces, volume, scan_face_normals, cscale = scan
        deformed_norms = compute_vertex_normals(deformed, faces)
        if use_sdf and volume is not None:
            icp = sdf.point_cloud_loss_sdf(deformed, volume)
            nl = sdf.normal_loss_sdf(deformed, deformed_norms, volume,
                                     scan_face_normals)
        else:
            # one query shared by both terms
            near = nearest_points(deformed.reshape(-1, 3), scan_verts,
                                  scan_faces)
            icp = point_cloud_loss(deformed, scan_verts, scan_faces,
                                   nearest=near)
            nl = normal_loss(deformed, deformed_norms, scan_verts,
                             scan_faces, scan_face_normals, nearest=near)
        sm = normal_laplacian_smoothness(deformed_norms, faces)
        return icp + (nl + sm) * cscale * 0.1

    def disp_loss(disp):
        return torch.stack([frame_loss(body_vertices[b] + disp[b], scan)
                            for b, scan in enumerate(scans)])

    disp0 = torch.zeros_like(body_vertices)
    opt = Adam([disp0], [config.disp_lr], config.adam_b1, config.adam_b2)
    return disp_loss, opt, disp0
