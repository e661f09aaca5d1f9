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


def _views(obs):
    """The mask views' contours, contour weights, crops and crop origins,
    one row a (frame, view)."""
    B, C = obs["mask_w2c"].shape[:2]
    return (obs["contours"].reshape(B * C, -1, 2),
            obs["contour_valid"].reshape(B * C, -1),
            obs["crops"].reshape((B * C,) + obs["crops"].shape[2:]),
            obs["crop_origins"].reshape(B * C, 1, 2))


def _inside(uv, n):
    return (uv[..., 0] >= 0) & (uv[..., 0] < n) & (uv[..., 1] >= 0) \
        & (uv[..., 1] < n)


def _pixel_weight(crops, origin, matched, n, epsilon):
    """The ICP weight of each matched position: the mask at its pixel
    (the position cast to float32 and truncated), ``epsilon`` where that
    reads under 0.1 (outside the silhouette), else 1."""
    px = matched.to(torch.float32).to(torch.int32).clamp(0, int(n) - 1)
    at = bilinear(crops, (px.to(crops.dtype) - origin))
    return torch.where(at < 0.1, epsilon, 1.0).to(matched.dtype)


def mask_term(cfg, obs, verts, epsilon=10.0):
    """Both silhouette terms per frame ``[B]``: ``verts`` are the posed,
    scaled vertices the term reads (every 4th, in the fit's order)."""
    B, C = obs["mask_w2c"].shape[:2]
    n = cfg["imsize"]
    uv = project(verts, obs["mask_w2c"], obs["mask_K"]).reshape(B * C, -1, 2)
    contour, cvalid, crops, origin = _views(obs)
    inside = _inside(uv, n)
    d2 = ((contour[:, :, None] - uv[:, None].detach()) ** 2).sum(-1)
    d2 = torch.where(inside[:, None], d2, torch.full_like(d2, float("inf")))
    idx = d2.argmin(-1)                                       # [BC, P]
    found = inside.any(-1, keepdim=True)
    matched = uv.gather(1, idx[..., None].expand(-1, -1, 2))
    dist = torch.sqrt(((contour - matched) ** 2).sum(-1) + 1e-12)
    dist = torch.where(found, dist, torch.zeros_like(dist))
    with torch.no_grad():
        coeff = _pixel_weight(crops, origin, matched, n, epsilon)
    icp = (dist * coeff * cvalid).sum(-1)
    xy = uv * ((n - 1) / n)
    cov = ((torch.minimum(xy[..., 1] + 1, n - xy[..., 1]).clamp(0, 1))
           * (torch.minimum(xy[..., 0] + 1, n - xy[..., 0]).clamp(0, 1)))
    inside_sum = (cov - bilinear(crops, xy - origin)).sum(-1) \
        * obs["view_valid"].reshape(-1)
    return (icp + epsilon * inside_sum).reshape(B, C).sum(1)


# ---------------------------------------------------------------------------
# Near-ties: the objective's discrete decisions that float32 rounding can
# take otherwise
# ---------------------------------------------------------------------------
#
# The staged objective passes through four discrete decisions: the contour
# pixel's nearest projected vertex (an argmin), the truncation of the
# matched position to a pixel, the 1-or-``epsilon`` weight of that pixel
# (its mask value against 0.1), and the face landmarks' whole degree of
# yaw.  A float32 evaluation and a float64 one decide alike except where
# the float64 quantity lies within float32 rounding of its threshold; there
# the loss may jump by that decision's whole effect, and nothing is wrong.
# The bands below bound how far float32 can carry each quantity, from the
# unit roundoff ``U`` and the size of the quantities; the functions find,
# at the given parameters, every decision inside its band and the most the
# loss changes when that decision alone is taken the other way.  The
# gradient passes through two more, where the loss is continuous and its
# derivative is not: the cell of the "stay inside" bilinear sample, and
# the pose prior's nearest component; its allowance is taken leaf by leaf.

U = 2.0 ** -24          # float32's unit roundoff
# The program's float32 pixel coordinate ends a chain of float32
# operations (the blend shapes' and the skinning's sums to the vertex, the
# camera transform, the divide) on quantities of two sizes: the vertex
# coordinates (the frame's largest), seen through the projection's
# derivative, and the pixel value.  16 roundings of each bound it: the
# program's routes (separate and fused mask terms, plain and fused
# skinning) read at most 2.5 of them on the card (PERF.md).
PIXEL_ROUND = 16 * U
# The yaw: each rotation of the neck chain comes from its axis-angle and
# the chain multiplies five of them, on quantities at most 1: 32
# roundings bound it (the program's routes read at most 5).
YAW_ROUND = 32 * U * 180.0 / np.pi      # degrees


def projection_band(verts, w2c, K):
    """How far float32 can carry each projected coordinate ``[B, C, N,
    2]`` (pixels): ``PIXEL_ROUND`` of the frame's largest vertex
    coordinate through the perspective divide's derivative ``f / z (1 +
    |x / z|)``, and of the pixel value ``|u| + |c|``."""
    cam = torch.einsum("bcij,bnj->bcni", w2c[..., :3, :3], verts) \
        + w2c[:, :, None, :3, 3]
    z = cam[..., 2:3]
    f = torch.stack([K[..., 0, 0], K[..., 1, 1]], -1)[:, :, None]
    c = K[..., :2, 2][:, :, None]
    vmax = verts.abs().amax(dim=(1, 2))[:, None, None, None]
    uv = f * cam[..., :2] / z + c
    return PIXEL_ROUND * ((f / z.abs()) * (1 + (cam[..., :2] / z).abs())
                          * vmax + uv.abs() + c.abs())


def _match_options(n, uv, band, contour, crops, origin, epsilon):
    """One frame's contour matches and their near-tied alternatives: the
    reference's own nearest vertex ``idx [C, P]`` and weight ``w0``; for
    each pixel the ``k`` candidate vertices ``cand [C, P, k]`` (``live``)
    whose squared distance lies within both candidates' float32 bands of
    the nearest (``projection_band`` through ``d2``'s derivative, and 4 U
    of ``d2``), their distances ``dist``, and whether each can take the
    weight ``epsilon`` (``can_eps``) or 1 (``can_one``): at the pixel
    either side of each matched coordinate's band, truncated, a mask
    sample under 0.1 or within 4 U of it, and at least 0.1 or within 4 U
    of it; ``found [C, 1]``, a view with a vertex inside the image."""
    inside = _inside(uv, n)
    diff = (contour[:, :, None] - uv[:, None]).abs()          # [C, P, M, 2]
    d2 = (diff ** 2).sum(-1)
    dband = (2 * diff * band[:, None] + band[:, None] ** 2).sum(-1) \
        + 4 * U * d2
    d2 = torch.where(inside[:, None], d2, torch.full_like(d2, float("inf")))
    best, idx = d2.min(-1)                                    # [C, P]
    bband = dband.gather(2, idx[..., None])
    tie = d2 - best[..., None] <= dband + bband               # [C, P, M]
    k = int(tie.sum(-1).max())
    cand = torch.where(tie, d2, torch.full_like(d2, float("inf"))
                       ).topk(k, dim=-1, largest=False)
    live = torch.isfinite(cand.values)                        # [C, P, k]
    gi = cand.indices[..., None].expand(-1, -1, -1, 2)
    m = uv[:, None].expand(-1, contour.shape[1], -1, -1).gather(2, gi)
    mb = band[:, None].expand(-1, contour.shape[1], -1, -1).gather(2, gi)
    dist = torch.sqrt(((contour[:, :, None] - m) ** 2).sum(-1) + 1e-12)
    lo = torch.floor(m - mb).clamp(0, int(n) - 1)
    hi = torch.floor(m + mb).clamp(0, int(n) - 1)
    px = torch.stack([torch.stack([lo[..., 0], lo[..., 1]], -1),
                      torch.stack([lo[..., 0], hi[..., 1]], -1),
                      torch.stack([hi[..., 0], lo[..., 1]], -1),
                      torch.stack([hi[..., 0], hi[..., 1]], -1)], -2)
    C = uv.shape[0]
    at = bilinear(crops, px.reshape(C, -1, 2).to(crops.dtype)
                  - origin).reshape(px.shape[:-1])            # [C, P, k, 4]
    near = (at - 0.1).abs() <= 4 * U * (1 + at.abs())
    matched = uv.gather(1, idx[..., None].expand(-1, -1, 2))
    return dict(idx=idx, w0=_pixel_weight(crops, origin, matched, n, epsilon),
                matched=matched, cand=cand.indices, live=live, dist=dist,
                can_eps=((at < 0.1) | near).any(-1),
                can_one=((at >= 0.1) | near).any(-1),
                found=inside.any(-1, keepdim=True))


def _frame_views(obs, b):
    """Frame ``b``'s mask views: ``(w2c, K, contour, cvalid, crops,
    origin)``, one row a view."""
    C = obs["mask_w2c"].shape[1]
    sl = slice(b * C, (b + 1) * C)
    return (obs["mask_w2c"][b:b + 1], obs["mask_K"][b:b + 1]) + tuple(
        x[sl] for x in _views(obs))


@torch.no_grad()
def mask_term_ties(cfg, obs, verts, epsilon=10.0):
    """Per frame ``[B]``: the sum, over the contour pixels, of the most a
    pixel's ICP term (its matched distance times its weight) changes when
    its near-tied decisions are taken otherwise (:func:`_match_options`:
    another vertex, the neighbouring pixel of a matched coordinate, the
    other weight of a sample at 0.1); a flipped match carries its own
    pixel and weight.  The units of :func:`mask_term` (before
    ``mask_weight``).  A vertex's inside test is not among them: the rigs
    keep the body far from the image's border."""
    B = obs["mask_w2c"].shape[0]
    n = cfg["imsize"]
    out = []
    for b in range(B):
        w2c, K, contour, cvalid, crops, origin = _frame_views(obs, b)
        v = verts[b:b + 1]
        o = _match_options(n, project(v, w2c, K)[0],
                           projection_band(v, w2c, K)[0], contour, crops,
                           origin, epsilon)
        live, dist = o["live"], o["dist"]
        big = torch.where(live, dist * torch.where(o["can_eps"], epsilon,
                                                   1.0),
                          torch.full_like(dist, -float("inf"))).amax(-1)
        small = torch.where(live, dist * torch.where(o["can_one"], 1.0,
                                                     epsilon),
                            torch.full_like(dist, float("inf"))).amin(-1)
        here = torch.sqrt(((contour - o["matched"]) ** 2).sum(-1) + 1e-12) \
            * o["w0"]
        jump = torch.maximum(big - here, here - small) * cvalid
        out.append(torch.where(o["found"], jump, torch.zeros_like(jump)).sum())
    return torch.stack(out)


def mask_view_jacobian(model, obs, p):
    """The mask views' projected vertices ``uv [B, C, M, 2]`` (the rows
    :func:`mask_term` reads), their float32 bands (``projection_band``)
    and their Jacobian ``[B, C, M, 2, D]`` in the frame's own parameters,
    ``PARAM_FIELDS`` flattened in order (forward mode, one parameter at a
    time)."""
    import torch.autograd.forward_ad as fwad

    def verts_of(q):
        verts, _ = body.forward(model, q)
        scale = (q["body_scale"] * obs["constant_scale"][:, None])[:, :, None]
        return ((verts + q["global_transl"][:, None]) * scale)[
            :, obs["mask_rows"]]

    w2c, K = obs["mask_w2c"], obs["mask_K"]
    cols = []
    with torch.no_grad():
        v = verts_of(p)
        uv, band = project(v, w2c, K), projection_band(v, w2c, K)
        for f in PARAM_FIELDS:
            for e in range(p[f].shape[1]):
                tan = torch.zeros_like(p[f])
                tan[:, e] = 1.0
                with fwad.dual_level():
                    q = dict(p, **{f: fwad.make_dual(p[f], tan)})
                    cols.append(fwad.unpack_dual(
                        project(verts_of(q), w2c, K)).tangent)
    return uv, band, torch.stack(cols, -1)


def _leaf_norms(x, sizes):
    """Per leaf (``sizes`` along the last axis) the norm of ``x [...,
    D]``: ``[..., leaves]``."""
    return torch.stack([c.norm(dim=-1) for c in x.split(sizes, -1)], -1)


@torch.no_grad()
def mask_grad_ties(cfg, obs, sizes, uv, band, jac, epsilon=10.0):
    """Per frame and leaf ``[B, leaves]``: the sum, over the mask term's
    near-tied decisions, of the most the leaf's gradient (before
    ``mask_weight``) changes when that decision alone is taken the other
    way: a contour pixel's match, pixel and weight
    (:func:`_match_options`; the pixel's pull ``w (uv - c) / |uv - c|``
    moves to its other vertex or weight), and the cell of the "stay
    inside" bilinear sample, whose derivative across a pixel border jumps
    where the mask steps: a sample coordinate ``xy = uv (n - 1) / n - o``
    within its band of an integer (``projection_band`` scaled, and 4 U of
    ``|xy| + |o|`` for the scaling and the crop's offset).  ``sizes``:
    the leaves' sizes along ``jac``'s last axis; ``uv``, ``band``,
    ``jac``: :func:`mask_view_jacobian`."""
    B = obs["mask_w2c"].shape[0]
    n = cfg["imsize"]
    out = []
    for b in range(B):
        _, _, contour, cvalid, crops, origin = _frame_views(obs, b)
        J = jac[b]                                            # [C, M, 2, D]
        o = _match_options(n, uv[b], band[b], contour, crops, origin,
                           epsilon)
        C, P, k = o["cand"].shape

        def pull(j, w):
            # the pixel's gradient in its vertex's uv, through the Jacobian
            m = uv[b].gather(1, j.reshape(C, -1, 1).expand(-1, -1, 2)
                             ).reshape(j.shape + (2,))
            d = m - contour.reshape((C, P) + (1,) * (j.dim() - 2) + (2,))
            u = d / torch.sqrt((d ** 2).sum(-1, keepdim=True) + 1e-12)
            Jj = J.gather(1, j.reshape(C, -1, 1, 1).expand(
                -1, -1, 2, J.shape[-1])).reshape(j.shape + J.shape[-2:])
            return torch.einsum("...e,...ed->...d", w[..., None] * u, Jj)

        base = pull(o["idx"], o["w0"])                        # [C, P, D]
        opts = torch.stack([
            pull(o["cand"], torch.full_like(o["dist"], epsilon)),
            pull(o["cand"], torch.ones_like(o["dist"]))], -2)  # [C,P,k,2,D]
        ok = torch.stack([o["can_eps"], o["can_one"]], -1) \
            & o["live"][..., None]
        dn = _leaf_norms(opts - base[:, :, None, None], sizes)
        dn = torch.where(ok[..., None], dn, torch.zeros_like(dn))
        icp = (dn.amax(dim=(2, 3))
               * (cvalid * o["found"])[..., None]).sum((0, 1))
        # the stay-inside sample's cell
        s = (n - 1) / n
        xy = uv[b] * s - origin                               # [C, M, 2]
        sb = band[b] * s + 4 * U * (xy.abs() + origin.abs())
        kx = torch.round(xy)
        near = (xy - kx).abs() <= sb
        jump = _cell_jump(crops, xy, kx)                      # [C, M, 2]
        g = (epsilon * s * jump * near
             * obs["view_valid"][b][:, None, None])           # [C, M, 2]
        cell = _leaf_norms(g[..., None] * J, sizes).sum((0, 1, 2))
        out.append(icp + cell)
    return torch.stack(out)


def _cell_jump(crops, xy, k):
    """Per coordinate of each sample ``xy [C, M, 2]``: the change of the
    zero-padded bilinear sample's derivative along that coordinate when
    the cell's border at ``k`` (the nearest integer) is crossed, from the
    cell below it to the cell above."""
    C, M = xy.shape[:2]

    def m(r, c):
        return bilinear(crops, torch.stack([c, r], -1).reshape(C, -1, 2)
                        ).reshape(r.shape)

    x, y = xy[..., 0], xy[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    kx, ky = k[..., 0], k[..., 1]
    # along x at the border kx: second difference of the mask across it,
    # on the two rows the sample blends
    jx = ((1 - wy) * (m(y0, kx + 1) - 2 * m(y0, kx) + m(y0, kx - 1))
          + wy * (m(y0 + 1, kx + 1) - 2 * m(y0 + 1, kx) + m(y0 + 1, kx - 1)))
    jy = ((1 - wx) * (m(ky + 1, x0) - 2 * m(ky, x0) + m(ky - 1, x0))
          + wx * (m(ky + 1, x0 + 1) - 2 * m(ky, x0 + 1) + m(ky - 1, x0 + 1)))
    return torch.stack([jx, jy], -1)


# The pose prior's max-mixture picks its nearest component, and its
# gradient jumps to another where two tie.  The program's float32 value
# of component k, 0.5 d^T P d - log w with d = x - mu (x exact, mu, P and
# log w rounded once), ends a matrix-vector product and a dot product of
# length D: to first order within (2 D + 3) U of |d|^T |P| (|d| + |mu|)
# and 2 U of |log w|.  4 U (D + 2) of their sum bounds it.
GMM_ROUND = 4 * U


@torch.no_grad()
def gmm_grad_ties(cfg, prior, p, sizes):
    """Per frame and leaf ``[B, leaves]``: the most the pose prior's
    gradient (``body_pose``'s leaf) changes when its nearest component is
    taken as another whose value lies within both components' float32
    bands (``GMM_ROUND``) of it."""
    pose = p["body_pose"]
    pose69 = torch.cat([pose, pose.new_zeros(pose.shape[0],
                                             69 - pose.shape[1])], 1)
    d = pose69[:, None, :] - prior.means                    # [B, K, D]
    pd = torch.einsum("kij,bkj->bki", prior.prec, d)
    nll = 0.5 * (pd * d).sum(-1) - prior.logw
    size = (torch.einsum("kij,bkj->bki", prior.prec.abs(), d.abs())
            * (d.abs() + prior.means.abs())).sum(-1) + prior.logw.abs()
    band = GMM_ROUND * (d.shape[-1] + 2) * size
    best, k0 = nll.min(-1)
    tie = nll - best[:, None] <= band + band.gather(1, k0[:, None])
    grad = cfg["pose_prior_weight"] ** 2 * pd[..., :pose.shape[1]]
    own = grad.gather(1, k0[:, None, None].expand(-1, 1, grad.shape[-1]))
    jump = torch.where(tie, (grad - own).norm(dim=-1),
                       torch.zeros_like(nll)).amax(-1)
    out = pose.new_zeros(pose.shape[0], len(sizes))
    out[:, PARAM_FIELDS.index("body_pose")] = jump
    return out


@torch.no_grad()
def yaw_ties(model, p):
    """``None``, or the whole degrees ``[B]`` of the other branch: each
    frame whose yaw lies within ``YAW_ROUND`` of a half degree (below the
    clamp at 39) takes the whole degree on the other side, the others keep
    theirs.  Only SMPL-X's face landmarks read the yaw."""
    if model.kind != "smplx":
        return None
    yaw = body.yaw_degrees(model, body.full_pose(model, p))
    deg = body.whole_degrees(yaw)
    t = torch.clamp(yaw, max=39.0)
    low = torch.floor(t)
    near = ((t - (low + 0.5)).abs() <= YAW_ROUND) & (low + 0.5 < 39.0)
    if not bool(near.any()):
        return None
    other = torch.where(deg > low, low, low + 1).long()
    return torch.where(near, other, deg)


@torch.no_grad()
def fit_loss_ties(cfg, model, obs, p, step):
    """Per frame ``[B]``: the most the staged objective at ``step`` moves
    when the mask term's near-tied decisions (:func:`mask_term_ties`) are
    taken otherwise, each alone, summed; 0 before the gate or without
    masks.  The yaw's tie is not among them: its jump moves all 17 contour
    landmarks (up to a tenth of the loss on the seeded models), so the
    loss at the other whole degree is compared as a branch of its own
    (:func:`yaw_ties`)."""
    if not (cfg.get("use_mask")
            and step > cfg["num_iters"] // cfg["stage_gate_den"]):
        return p["betas"].new_zeros(p["betas"].shape[0])
    verts, _ = body.forward(model, p)
    scale = (p["body_scale"] * obs["constant_scale"][:, None])[:, :, None]
    v = (verts + p["global_transl"][:, None]) * scale
    return cfg["mask_weight"] * mask_term_ties(cfg, obs,
                                               v[:, obs["mask_rows"]])


@torch.no_grad()
def fit_grad_ties(cfg, model, obs, p, step, prior):
    """Per frame and leaf ``[B, len(PARAM_FIELDS)]``: the most each leaf's
    gradient of the staged objective at ``step`` moves when its near-tied
    decisions are taken the other way, each alone, summed: the pose
    prior's component (:func:`gmm_grad_ties`) and, after the gate with
    masks, the mask term's (:func:`mask_grad_ties`).  The yaw's tie is a
    branch of its own (:func:`yaw_ties`)."""
    sizes = [p[f].shape[1] for f in PARAM_FIELDS]
    out = gmm_grad_ties(cfg, prior, p, sizes)
    if cfg.get("use_mask") \
            and step > cfg["num_iters"] // cfg["stage_gate_den"]:
        uv, band, jac = mask_view_jacobian(model, obs, p)
        out = out + cfg["mask_weight"] * mask_grad_ties(cfg, obs, sizes, uv,
                                                        band, jac)
    return out


def fit_loss(cfg, model, obs, p, step, prior, volume=None, deg=None):
    """The staged objective per frame at iteration ``step``; ``deg`` forces
    the face landmarks' whole degree of yaw (:func:`body.face_landmarks`)."""
    verts, joints = body.forward(model, p, deg)
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


def follow(loss_fn, tensors, lrs, steps, flip=None, on_step=None):
    """The losses ``[B, steps]`` of ``steps`` Adam steps on ``loss_fn(i,
    tensors)`` (per frame), each taken before its update, and the final
    tensors.  ``flip``: ``(step, deg)``, the whole degrees of yaw forced
    at that step, as ``loss_fn(i, tensors, deg)``; ``on_step(i,
    tensors)`` sees each step's tensors before its loss."""
    tensors = [x.detach().clone() for x in tensors]
    opt = Adam(tensors, lrs)
    out = []
    for i in range(steps):
        if on_step is not None:
            on_step(i, tensors)
        for x in tensors:
            x.requires_grad_(True)
        if flip is not None and flip[0] == i:
            loss = loss_fn(i, tensors, flip[1])
        else:
            loss = loss_fn(i, tensors)
        grads = torch.autograd.grad(loss.sum(), tensors, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(tensors, grads)]
        for x in tensors:
            x.requires_grad_(False)
        opt.step(grads)
        out.append(loss.detach())
    return torch.stack(out, 1), tensors


def follow_branches(loss_fn, tensors, lrs, steps, model):
    """``[branches, B, steps]``: :func:`follow`, and for each step at
    which a frame's yaw lies within rounding of a half degree
    (:func:`yaw_ties`), the same follow with that step's whole degree
    taken the other way, from where float32 may part from float64."""
    flips = []

    def peek(i, ts):
        deg = yaw_ties(model, dict(zip(PARAM_FIELDS, ts)))
        if deg is not None:
            flips.append((i, deg))

    main, _ = follow(loss_fn, tensors, lrs, steps, on_step=peek)
    return torch.stack([main] + [follow(loss_fn, tensors, lrs, steps,
                                        flip=f)[0] for f in flips])
