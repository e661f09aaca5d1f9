"""Plain fitting objective: keypoints and priors, the two silhouette
terms, the scan terms and the SMPL+D terms, and Adam.

Written from SMPLify's objective as the GeneBody and RenderPeople fits
state it (Bogo et al. 2016; the apps' staged weights): Geman-McClure
reprojection in every view, the GMM max-mixture pose prior, the
knee/elbow angle prior and an L2 shape prior; after the gate, the mask
terms (contour ICP to the nearest projected vertex, weighted 10x where
the vertex's pixel is outside the mask, and the bilinear "stay inside"
sample of ``1 - mask``) or the point-to-scan distance read from the
trilinear distance volume; SMPL+D's scan distance, normal agreement and
normal smoothness.  Dense, one formula at a time: no kernel, no cache.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

from benchmark.reference import body

PARAM_FIELDS = ("betas", "global_orient", "body_pose", "expression",
                "jaw_pose", "leye_pose", "reye_pose", "left_hand_pose",
                "right_hand_pose", "global_transl", "body_scale")
ANGLE_IDS, ANGLE_SIGNS = (52, 55, 9, 12), (1.0, -1.0, -1.0, -1.0)


class GMMPrior:
    """``min_k 0.5 (x - mu_k)^T Sigma_k^-1 (x - mu_k) - log w'_k`` with
    ``w'_k = w_k / ((2 pi)^(D/2) sqrt|Sigma_k| / min_j sqrt|Sigma_j|)``,
    from the ``gmm_08.pkl`` arrays."""

    def __init__(self, path, dtype=torch.float64, device="cpu"):
        with open(path, "rb") as f:
            g = pickle.load(f, encoding="latin1")
        means = np.asarray(g["means"], np.float64)
        covs = np.asarray(g["covars"], np.float64)
        w = np.asarray(g["weights"], np.float64)
        sq = np.sqrt(np.linalg.det(covs))
        nw = w / ((2 * np.pi) ** (means.shape[1] / 2) * (sq / sq.min()))
        self.means = torch.as_tensor(means, dtype=dtype, device=device)
        self.prec = torch.as_tensor(np.linalg.inv(covs), dtype=dtype,
                                    device=device)
        self.logw = torch.as_tensor(np.log(nw), dtype=dtype, device=device)

    def __call__(self, pose69):
        d = pose69[:, None, :] - self.means                 # [B, K, D]
        quad = torch.einsum("bki,kij,bkj->bk", d, self.prec, d)
        return (0.5 * quad - self.logw).min(-1).values


def gmof(x, sigma):
    return sigma ** 2 * x ** 2 / (sigma ** 2 + x ** 2)


def project(points, w2c, K):
    """Points ``[B, N, 3]`` into cameras ``w2c [B, C, 4, 4]``, ``K [B, C,
    3, 3]``: pixels ``[B, C, N, 2]``."""
    cam = torch.einsum("bcij,bnj->bcni", w2c[..., :3, :3], points) \
        + w2c[:, :, None, :3, 3]
    uvw = torch.einsum("bcij,bcnj->bcni", K, cam)
    return uvw[..., :2] / uvw[..., 2:3]


def keypoint_term(cfg, obs, p, joints, prior, hand_face):
    """Reprojection of the model joints in every view, and the priors,
    per frame ``[B]``."""
    scale = (p["body_scale"] * obs["constant_scale"][:, None])[:, :, None]
    j = (joints + p["global_transl"][:, None]) * scale
    uv = project(j, obs["w2c"], obs["K"])                    # [B, C, J, 2]
    kp = obs["keypoints"]
    conf2 = kp[..., 2] ** 2
    err = gmof((kp[..., :2] - uv[..., :kp.shape[2], :])
               / (cfg["imsize"] / 1024.0), cfg["sigma"]).sum(-1)
    per_view = (conf2 * err).sum(-1) * obs["view_mask"]     # [B, C]
    loss = per_view.sum(1) / obs["num_views"]
    pose = p["body_pose"]
    pose69 = torch.cat([pose, pose.new_zeros(pose.shape[0],
                                             69 - pose.shape[1])], 1)
    signs = torch.as_tensor(ANGLE_SIGNS, dtype=pose.dtype, device=pose.device)
    angle = torch.exp(pose69[:, list(ANGLE_IDS)] * signs) ** 2
    return (loss + cfg["pose_prior_weight"] ** 2 * prior(pose69)
            + cfg["angle_prior_weight"] ** 2 * angle.sum(-1)
            + cfg["shape_prior_weight"] ** 2 * (p["betas"] ** 2).sum(-1))


def bilinear(img, xy):
    """Zero-padded bilinear samples of ``img [N, H, W]`` at pixel-grid
    positions ``xy [N, P, 2]``, differentiable in ``xy``."""
    N, H, W = img.shape
    x, y = xy[..., 0], xy[..., 1]
    x0, y0 = torch.floor(x).detach(), torch.floor(y).detach()
    wx, wy = x - x0, y - y0
    x0, y0 = x0.long(), y0.long()
    flat = img.reshape(N, -1)

    def tap(r, c):
        ok = (r >= 0) & (r < H) & (c >= 0) & (c < W)
        v = flat.gather(1, (r.clamp(0, H - 1) * W + c.clamp(0, W - 1)))
        return torch.where(ok, v, torch.zeros_like(v))

    return ((1 - wy) * ((1 - wx) * tap(y0, x0) + wx * tap(y0, x0 + 1))
            + wy * ((1 - wx) * tap(y0 + 1, x0) + wx * tap(y0 + 1, x0 + 1)))


def mask_term(cfg, obs, verts, epsilon=10.0):
    """Both silhouette terms per frame ``[B]``: ``verts`` are the posed,
    scaled vertices the term reads (every 4th, in the fit's order)."""
    B, C = obs["mask_w2c"].shape[:2]
    n = cfg["imsize"]
    uv = project(verts, obs["mask_w2c"], obs["mask_K"]).reshape(B * C, -1, 2)
    contour = obs["contours"].reshape(B * C, -1, 2)
    cvalid = obs["contour_valid"].reshape(B * C, -1)
    crops = obs["crops"].reshape((B * C,) + obs["crops"].shape[2:])
    origin = obs["crop_origins"].reshape(B * C, 1, 2)
    inside = (uv[..., 0] >= 0) & (uv[..., 0] < n) & (uv[..., 1] >= 0) \
        & (uv[..., 1] < n)
    d2 = ((contour[:, :, None] - uv[:, None].detach()) ** 2).sum(-1)
    d2 = torch.where(inside[:, None], d2, torch.full_like(d2, float("inf")))
    idx = d2.argmin(-1)                                       # [BC, P]
    found = inside.any(-1, keepdim=True)
    matched = uv.gather(1, idx[..., None].expand(-1, -1, 2))
    dist = torch.sqrt(((contour - matched) ** 2).sum(-1) + 1e-12)
    dist = torch.where(found, dist, torch.zeros_like(dist))
    with torch.no_grad():
        px = matched.to(torch.float32).to(torch.int32).clamp(0, int(n) - 1)
        at = bilinear(crops, (px.to(crops.dtype) - origin))
        coeff = torch.where(at < 0.1, epsilon, 1.0).to(uv.dtype)
    icp = (dist * coeff * cvalid).sum(-1)
    xy = uv * ((n - 1) / n)
    cov = ((torch.minimum(xy[..., 1] + 1, n - xy[..., 1]).clamp(0, 1))
           * (torch.minimum(xy[..., 0] + 1, n - xy[..., 0]).clamp(0, 1)))
    inside_sum = (cov - bilinear(crops, xy - origin)).sum(-1) \
        * obs["view_valid"].reshape(-1)
    return (icp + epsilon * inside_sum).reshape(B, C).sum(1)


def fit_loss(cfg, model, obs, p, step, prior, volume=None):
    """The staged objective per frame at iteration ``step``."""
    verts, joints = body.forward(model, p)
    hand_face = model.kind == "smplx"
    total = keypoint_term(cfg, obs, p, joints, prior, hand_face)
    if step <= cfg["num_iters"] // cfg["stage_gate_den"]:
        return total
    scale = (p["body_scale"] * obs["constant_scale"][:, None])[:, :, None]
    v = (verts + p["global_transl"][:, None]) * scale
    if cfg.get("use_mask"):
        total = total + cfg["mask_weight"] * mask_term(
            cfg, obs, v[:, obs["mask_rows"]])
    if cfg.get("use_mesh"):
        pc = torch.stack([scan_distance(volume, v[b])
                          for b in range(v.shape[0])])
        total = total + cfg["pc_weight"] * pc / obs["scan_height"] \
            * cfg["imsize"]
    return total


def scan_distance(volume, points):
    """``sqrt(sum_i d_i^2)`` of the trilinear distances at ``points``."""
    d = volume.query(points)
    return torch.sqrt((d * d).sum() + 1e-20)


def unit(x):
    n = torch.linalg.norm(x, dim=-1, keepdim=True)
    return x / (n + 1e-8)


def vertex_normals(v, faces):
    """Unit normals: unit face normals summed onto their corners, again
    made unit."""
    t = v[faces]
    fn = unit(torch.linalg.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0],
                                 dim=-1))
    acc = torch.zeros_like(v)
    for k in range(3):
        acc = acc.index_add(0, faces[:, k], fn)
    return unit(acc)


def displacement_loss(volume, scan_face_normals, cscale, body_verts, disp,
                      faces):
    """SMPL+D's objective for one scan: the scan distance of the displaced
    vertices, plus 0.1 x the scale x (normal disagreement with the scan
    face nearest each vertex + normal smoothness along the edges)."""
    v = body_verts + disp
    n = vertex_normals(v, faces)
    fid = volume.nearest_face(v.detach())
    nl = (1.0 - (scan_face_normals[fid] * n).sum(-1)).mean()
    t = n[faces]
    sm = (((t[:, 0] - t[:, 1]) ** 2).sum(-1)
          + ((t[:, 2] - t[:, 0]) ** 2).sum(-1)
          + ((t[:, 1] - t[:, 2]) ** 2).sum(-1)).mean()
    return scan_distance(volume, v) + (nl + sm) * cscale * 0.1


class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected), a learning rate
    a tensor; a rate of 0 leaves its tensor and moments alone."""

    def __init__(self, tensors, lrs, b1=0.9, b2=0.999, eps=1e-8):
        self.t, self.lrs = tensors, lrs
        self.b1, self.b2, self.eps = b1, b2, eps
        self.m = [torch.zeros_like(x) for x in tensors]
        self.v = [torch.zeros_like(x) for x in tensors]
        self.n = 0

    @torch.no_grad()
    def step(self, grads):
        self.n += 1
        c1, c2 = 1 - self.b1 ** self.n, 1 - self.b2 ** self.n
        for x, g, m, v, lr in zip(self.t, grads, self.m, self.v, self.lrs):
            if lr == 0.0:
                continue
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            x.sub_(lr * (m / c1) / (torch.sqrt(v / c2) + self.eps))


def body_lrs(cfg):
    """Per-tensor rates in ``PARAM_FIELDS`` order: jaw and expression
    frozen, translation and scale at their own rate."""
    frozen = ("expression", "jaw_pose")
    return [0.0 if f in frozen else
            cfg["transl_lr"] if f in ("global_transl", "body_scale")
            else cfg["step_size"] for f in PARAM_FIELDS]


def follow(loss_fn, tensors, lrs, steps):
    """The losses ``[B, steps]`` of ``steps`` Adam steps on ``loss_fn(i,
    tensors)`` (per frame), each taken before its update, and the final
    tensors."""
    tensors = [x.detach().clone() for x in tensors]
    opt = Adam(tensors, lrs)
    out = []
    for i in range(steps):
        for x in tensors:
            x.requires_grad_(True)
        loss = loss_fn(i, tensors)
        grads = torch.autograd.grad(loss.sum(), tensors, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(tensors, grads)]
        for x in tensors:
            x.requires_grad_(False)
        opt.step(grads)
        out.append(loss.detach())
    return torch.stack(out, 1), tensors
