"""Mesh rasterization and UV texturing.

Counterpart of ``bodyfitting_tpu/ops/rasterize.py`` (:42-257): the hard
z-buffer (through the CUDA kernels of ``ops/kernels/raster.py`` on the
card), the winning face's perspective-correct barycentrics, attribute
interpolation and bilinear UV texture sampling.  Pixel centres are at
+0.5, faces are visible from both sides, depth is the camera-space z.

Only textures (and attributes) are differentiated: the z-buffer's face
assignment is a constant, the barycentric post-pass is plain PyTorch
(differentiable in the corners, as the JAX one), and the texture
gradient of :func:`bilinear_sample_uv` is the scatter-add of its gather,
summed in a fixed order on the card too (:mod:`ops.gather`).
:func:`soft_silhouette` is the SoftRas-style coverage, differentiable in
the vertices, in plain PyTorch (XLA in the JAX package, no kernel there).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bodyfitting_torch.ops import kernels as K
from bodyfitting_torch.ops.gather import (
    cached_row_index,
    gather_rows,
    row_index,
)

EPS = 1e-9
FAR = 1e9


class RasterOut(NamedTuple):
    face_idx: torch.Tensor   # [H, W] int32, -1 for background
    bary: torch.Tensor       # [H, W, 3] perspective-correct barycentrics
    depth: torch.Tensor      # [H, W] camera z (FAR for background)


def project_faces(verts: torch.Tensor, faces: torch.Tensor,
                  w2c: torch.Tensor, K_: torch.Tensor):
    """World vertices -> per-face screen coords and camera depths:
    ``(face_px [F, 3, 2], face_z [F, 3])``.  When ``verts`` needs a
    gradient, the corner gather's backward sums in a fixed order
    (:mod:`ops.gather`), as the vertex normals' does."""
    R, t = w2c[:3, :3], w2c[:3, 3]
    cam = verts @ R.T + t
    z = cam[:, 2]
    proj = cam @ K_.T
    px = proj[:, :2] / torch.clamp(proj[:, 2:3], min=EPS)
    if not verts.requires_grad:
        return px[faces], z[faces]
    index = cached_row_index(faces, verts.shape[0])
    F = faces.shape[0]
    return (gather_rows(px, index).reshape(F, 3, 2),
            gather_rows(z, index).reshape(F, 3))


def _edge(a, b, p):
    """2D edge function: cross(b - a, p - a)."""
    return (b[..., 0] - a[..., 0]) * (p[..., 1] - a[..., 1]) - (
        b[..., 1] - a[..., 1]) * (p[..., 0] - a[..., 0])


def pixel_centres(H: int, W: int, dtype, device) -> torch.Tensor:
    """``[H * W, 2]`` (x, y) pixel centres, row-major."""
    ys = (torch.arange(H, dtype=dtype, device=device) + 0.5)[:, None]
    xs = (torch.arange(W, dtype=dtype, device=device) + 0.5)[None, :]
    return torch.stack([xs.expand(H, W), ys.expand(H, W)], -1).reshape(-1, 2)


def rasterize(face_px: torch.Tensor, face_z: torch.Tensor, image_size: int,
              face_block: int = 256) -> RasterOut:
    """Hard z-buffer rasterization of projected triangles.

    The counterpart of both ``rz.rasterize`` and
    ``pallas_kernels.rasterize_pallas``: the z-buffer pass
    (:func:`ops.kernels.rasterize_zbuf`, the CUDA kernel for CUDA tensors)
    and then the winning face's barycentrics by ``rz.rasterize``'s
    post-pass (:135-149).  Depth is the z-buffer's, with the TPU kernel's
    arithmetic.  ``face_block`` is accepted for the JAX signature; the
    kernel blocks faces its own way.
    """
    del face_block
    H = W = int(image_size)
    depth, fidx = K.rasterize_zbuf(face_px, face_z, image_size)
    if face_px.shape[0] == 0:
        bary = face_px.new_zeros((H, W, 3))
        return RasterOut(face_idx=fidx, bary=bary, depth=depth)
    p = pixel_centres(H, W, face_px.dtype, face_px.device)
    flat = fidx.reshape(-1).long()
    safe = torch.clamp(flat, min=0)
    tri = face_px[safe]                                   # [P, 3, 2]
    z3 = face_z[safe]
    e0 = _edge(tri[:, 1], tri[:, 2], p)
    e1 = _edge(tri[:, 2], tri[:, 0], p)
    e2 = _edge(tri[:, 0], tri[:, 1], p)
    area = _edge(tri[:, 0], tri[:, 1], tri[:, 2])
    denom = torch.where(area.abs() > EPS, area, torch.ones_like(area))
    sb = torch.stack([e0, e1, e2], -1) / denom[:, None]   # screen bary
    w = sb / torch.clamp(z3, min=EPS)
    pc = w / torch.clamp(w.sum(-1, keepdim=True), min=EPS)
    bary = torch.where((flat >= 0)[:, None], pc, torch.zeros_like(pc))
    return RasterOut(face_idx=fidx, bary=bary.reshape(H, W, 3), depth=depth)


def render_attributes(raster: RasterOut, face_attrs: torch.Tensor,
                      background=0.0) -> torch.Tensor:
    """Interpolate per-face-vertex attributes ``[F, 3, C]`` over the raster
    into ``[H, W, C]``; differentiable w.r.t. the attributes."""
    H, W = raster.face_idx.shape
    flat = raster.face_idx.reshape(-1).long()
    C = face_attrs.shape[-1]
    if face_attrs.shape[0] == 0:
        return face_attrs.new_full((H, W, C), float(background))
    attrs = face_attrs[torch.clamp(flat, min=0)]          # [P, 3, C]
    vals = torch.einsum("pvc,pv->pc", attrs,
                        raster.bary.reshape(-1, 3).to(attrs.dtype))
    out = torch.where((flat >= 0)[:, None], vals,
                      torch.full_like(vals, float(background)))
    return out.reshape(H, W, C)


def render_silhouette(raster: RasterOut) -> torch.Tensor:
    """Hard binary coverage map ``[H, W]`` float32."""
    return (raster.face_idx >= 0).to(torch.float32)


def render_depth(raster: RasterOut, background: float = 0.0) -> torch.Tensor:
    """Depth map with the background filled."""
    return torch.where(raster.face_idx >= 0, raster.depth,
                       torch.full_like(raster.depth, float(background)))


def interpolate_uvs(raster: RasterOut, face_uvs: torch.Tensor) -> torch.Tensor:
    """Per-pixel interpolated UVs ``[H, W, 2]`` (0 where background)."""
    H, W = raster.face_idx.shape
    if face_uvs.shape[0] == 0:
        return face_uvs.new_zeros((H, W, 2))
    idx = torch.clamp(raster.face_idx.reshape(-1).long(), min=0)
    uvs = torch.einsum("pvc,pv->pc", face_uvs[idx],
                       raster.bary.reshape(-1, 3).to(face_uvs.dtype))
    return uvs.reshape(H, W, 2)


def bilinear_sample_uv(texture: torch.Tensor, uvs: torch.Tensor) -> torch.Tensor:
    """Bilinear texture lookup at UVs ``[..., 2]`` (OBJ convention: v up).

    A gather from the row-flattened texture; differentiable w.r.t. the
    texture and the UVs.  The texture's gradient sums the cotangent rows
    of each texel in ascending position (:func:`ops.gather.gather_rows`),
    as autograd's ``index_put_`` with ``accumulate`` does on the CPU.  On
    a CUDA device ``index_put_``'s float atomics would sum colliding rows
    in launch order, and the texture fit's Adam turns a last-bit
    difference at a texel whose gradient cancels into a whole step; in
    this order a rerun of a fit gives the same texture.
    """
    Th, Tw = texture.shape[:2]
    tex_flat = texture.reshape(Th * Tw, -1)
    flat = uvs.reshape(-1, 2)
    x = flat[:, 0] * (Tw - 1)
    y = (1.0 - flat[:, 1]) * (Th - 1)
    x0 = torch.clamp(torch.floor(x), 0, Tw - 1)
    y0 = torch.clamp(torch.floor(y), 0, Th - 1)
    x1 = torch.clamp(x0 + 1, 0, Tw - 1)
    y1 = torch.clamp(y0 + 1, 0, Th - 1)
    wx = torch.clamp(x - x0, 0.0, 1.0)[:, None]
    wy = torch.clamp(y - y0, 0.0, 1.0)[:, None]

    def tap(xi, yi):
        idx = yi.long() * Tw + xi.long()
        if not tex_flat.requires_grad:
            return tex_flat[idx]
        return gather_rows(tex_flat, row_index(idx, tex_flat.shape[0]))

    val = (tap(x0, y0) * (1 - wx) * (1 - wy)
           + tap(x1, y0) * wx * (1 - wy)
           + tap(x0, y1) * (1 - wx) * wy
           + tap(x1, y1) * wx * wy)
    return val.reshape(uvs.shape[:-1] + (texture.shape[-1],))


def sample_texture_uvmap(uv_map: torch.Tensor, fg: torch.Tensor,
                         texture: torch.Tensor, background=0.0):
    """Render from a precomputed per-pixel UV map and coverage mask.

    Only the covered pixels are sampled.  The background's UVs (0) would
    all gather one texel, and on the card the scatter-add of the texture
    gradient serialises such a pile-up (168 ms an Adam step at a 512²
    render on an H100, 4.7 ms with this form).
    """
    C = texture.shape[-1]
    sel = torch.nonzero(fg.reshape(-1))[:, 0]
    val = bilinear_sample_uv(texture, uv_map.reshape(-1, 2)[sel])
    out = val.new_full((fg.numel(), C), float(background))
    return out.index_put((sel,), val).reshape(fg.shape + (C,))


def sample_texture(raster: RasterOut, face_uvs: torch.Tensor,
                   texture: torch.Tensor, background=0.0) -> torch.Tensor:
    """Render by sampling a UV texture ``[Th, Tw, C]`` with per-face-vertex
    UVs ``[F, 3, 2]`` (v up); differentiable w.r.t. ``texture``."""
    uv_map = interpolate_uvs(raster, face_uvs)
    return sample_texture_uvmap(uv_map, raster.face_idx >= 0, texture,
                                background)


# ---------------------------------------------------------------------------
# Soft (differentiable-in-vertices) silhouette
# ---------------------------------------------------------------------------


def _point_segment_d2(p, a, b):
    """Squared distance point -> segment, broadcastable."""
    ab = b - a
    t = ((p - a) * ab).sum(-1) / torch.clamp((ab * ab).sum(-1), min=EPS)
    t = torch.clamp(t, 0.0, 1.0)[..., None]
    return ((p - (a + t * ab)) ** 2).sum(-1)


def _soft_log_bg(fpx, pix, sigma):
    """``sum_f log(1 - sigmoid(s_f))`` per pixel ``[P]`` over the faces
    ``fpx [f, 3, 2]`` (normalised coordinates): ``s_f`` is the squared
    distance to the face's edges over ``sigma``, positive inside."""
    a, b, c = fpx[None, :, 0], fpx[None, :, 1], fpx[None, :, 2]
    p = pix[:, None]
    e0 = _edge(b, c, p)
    e1 = _edge(c, a, p)
    e2 = _edge(a, b, p)
    inside = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0)) | (
        (e0 <= 0) & (e1 <= 0) & (e2 <= 0))
    d2 = torch.minimum(_point_segment_d2(p, a, b),
                       torch.minimum(_point_segment_d2(p, b, c),
                                     _point_segment_d2(p, c, a)))
    s = torch.where(inside, d2, -d2) / sigma
    # log(1 - sigmoid(s)) = -softplus(s), in its stable form (no
    # threshold: F.softplus returns s itself above 20)
    return -(torch.relu(s) + torch.log1p(torch.exp(-s.abs()))).sum(1)


# -log of the smallest subnormal, plus a margin: past this, exp(-s) is 0
_UNDERFLOW = {torch.float32: 110.0, torch.float64: 750.0}


class _SoftLogBackground(torch.autograd.Function):
    """:func:`_soft_log_bg` of every pixel over every face, by tiles of
    pixels.  A face adds exactly 0 (value and gradient) to a pixel more
    than ``sqrt(s_max sigma)`` from it, where ``exp(-d2 / sigma)``
    underflows, so each tile sums only the faces whose box, grown by that
    radius, meets the tile (the JAX function sums all of them, the same
    values).  Candidates go ``block`` faces at a time, and the backward
    recomputes each chunk and takes its gradient there: memory stays at
    one chunk both ways (the JAX ``lax.scan`` keeps every chunk's
    residuals)."""

    @staticmethod
    def forward(ctx, fpx, S, sigma, tile, block):
        ctx.save_for_backward(fpx)
        ctx.args = (S, sigma, tile, block)
        out = fpx.new_zeros((S, S))
        for ys, xs, pix, ids in _soft_tiles(fpx, S, sigma, tile):
            acc = pix.new_zeros(pix.shape[0])
            for c in range(0, ids.numel(), block):
                acc = acc + _soft_log_bg(fpx[ids[c:c + block]], pix, sigma)
            out[ys, xs] = acc.reshape(ys.stop - ys.start, xs.stop - xs.start)
        return out

    @staticmethod
    def backward(ctx, grad):
        (fpx,) = ctx.saved_tensors
        S, sigma, tile, block = ctx.args
        out = torch.zeros_like(fpx)
        with torch.enable_grad():
            for ys, xs, pix, ids in _soft_tiles(fpx, S, sigma, tile):
                g = grad[ys, xs].reshape(-1)
                for c in range(0, ids.numel(), block):
                    sel = ids[c:c + block]
                    chunk = fpx[sel].detach().requires_grad_(True)
                    val = _soft_log_bg(chunk, pix, sigma)
                    (gc,) = torch.autograd.grad(val, [chunk], g)
                    # a tile's faces are distinct: one add a row a
                    # chunk, in tile and chunk order (no atomics)
                    out[sel] = out[sel] + gc
        return out, None, None, None, None


def _soft_tiles(fpx, S, sigma, tile):
    """``(row slice, column slice, pixel centres [P, 2], candidate faces)``
    of each ``tile`` x ``tile`` block of pixels that some face's grown box
    meets; the candidates in ascending face order."""
    # no grad-mode context here: a generator would hold it over its
    # consumer's code between yields
    f = fpx.detach()
    r = (_UNDERFLOW[f.dtype] * sigma) ** 0.5
    lo = f.amin(1) - r                                     # [F, 2]
    hi = f.amax(1) + r
    for y0 in range(0, S, tile):
        ys = slice(y0, min(y0 + tile, S))
        cy0, cy1 = (y0 + 0.5) / S, (ys.stop - 0.5) / S
        rows = (hi[:, 1] >= cy0) & (lo[:, 1] <= cy1)
        for x0 in range(0, S, tile):
            xs = slice(x0, min(x0 + tile, S))
            cx0, cx1 = (x0 + 0.5) / S, (xs.stop - 0.5) / S
            ids = torch.nonzero(rows & (hi[:, 0] >= cx0)
                                & (lo[:, 0] <= cx1))[:, 0]
            if ids.numel() == 0:
                continue
            py = torch.arange(ys.start, ys.stop, dtype=f.dtype,
                              device=f.device) + 0.5
            px = torch.arange(xs.start, xs.stop, dtype=f.dtype,
                              device=f.device) + 0.5
            pix = torch.stack([px[None, :].expand(len(py), len(px)),
                               py[:, None].expand(len(py), len(px))],
                              -1).reshape(-1, 2) / S
            yield ys, xs, pix, ids


def soft_silhouette(face_px: torch.Tensor, image_size: int,
                    sigma: float = 1e-4, face_block=None,
                    face_z: torch.Tensor = None,
                    znear: float = 1e-6) -> torch.Tensor:
    """SoftRas-style probabilistic coverage ``[H, W]`` in [0, 1),
    differentiable in ``face_px [F, 3, 2]``.

    ``prob_f(p) = sigmoid(sign_f(p) d2(p, f) / sigma)`` with distances in
    normalised [0, 1] image units, aggregated as ``1 - prod_f (1 -
    prob_f) = 1 - exp(sum_f -softplus(s_f))``.  Faces with any vertex at
    ``face_z <= znear`` (``[F, 3]`` camera depths, as from
    :func:`project_faces`) are dropped, as the hard rasterizer's
    ``front`` test drops them, and so are degenerate faces (``|area| <=
    1e-9`` in normalised units).

    Pixels go by square tiles (32 pixels a side on a CUDA device, 16
    elsewhere), each over the faces near it, ``face_block`` faces at a
    time (the JAX signature's knob; by default about 2^25 pixel-face
    pairs a chunk on a CUDA device, 2^22 elsewhere).  Memory stays at one
    chunk in the backward too (:class:`_SoftLogBackground`).  float32 or
    float64 only.
    """
    S = int(image_size)
    cuda = face_px.device.type == "cuda"
    tile = 32 if cuda else 16
    if face_block is None:
        face_block = max(1, ((1 << 25) if cuda else (1 << 22)) // tile ** 2)
    fpx = face_px / image_size
    a, b, c = fpx[:, 0], fpx[:, 1], fpx[:, 2]
    valid = _edge(a, b, c).abs() > EPS
    if face_z is not None:
        valid = valid & (face_z > znear).all(-1)
    fpx = fpx[torch.nonzero(valid)[:, 0]]
    if fpx.shape[0] == 0:
        return face_px.new_zeros((S, S))
    log_bg = _SoftLogBackground.apply(fpx, S, float(sigma), tile,
                                      int(face_block))
    return 1.0 - torch.exp(log_bg)
