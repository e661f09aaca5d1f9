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
summed in a fixed order on the card too (:class:`_Gather`).
``soft_silhouette`` (:279, no caller on any path) is not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bodyfitting_torch.ops import kernels as K

EPS = 1e-9
FAR = 1e9


class RasterOut(NamedTuple):
    face_idx: torch.Tensor   # [H, W] int32, -1 for background
    bary: torch.Tensor       # [H, W, 3] perspective-correct barycentrics
    depth: torch.Tensor      # [H, W] camera z (FAR for background)


def project_faces(verts: torch.Tensor, faces: torch.Tensor,
                  w2c: torch.Tensor, K_: torch.Tensor):
    """World vertices -> per-face screen coords and camera depths:
    ``(face_px [F, 3, 2], face_z [F, 3])``."""
    R, t = w2c[:3, :3], w2c[:3, 3]
    cam = verts @ R.T + t
    z = cam[:, 2]
    proj = cam @ K_.T
    px = proj[:, :2] / torch.clamp(proj[:, 2:3], min=EPS)
    return px[faces], z[faces]


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


class _Gather(torch.autograd.Function):
    """``table[idx]`` (rows), whose backward sums the cotangent rows that
    share an index in ascending position, as autograd's ``index_put_``
    with ``accumulate`` does on the CPU: a stable sort of the indices,
    then one sum over each run.  On a CUDA device ``index_put_``'s float
    atomics would sum colliding rows in launch order, and the texture
    fit's Adam turns a last-bit difference at a texel whose gradient
    cancels into a whole step; in this order a rerun of a fit gives the
    same texture."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        out = grad.new_zeros((ctx.rows,) + grad.shape[1:])
        if idx.numel() == 0:
            return out, None
        rows, order = torch.sort(idx, stable=True)
        rows, counts = torch.unique_consecutive(rows, return_counts=True)
        out[rows] = torch.segment_reduce(grad[order], "sum", lengths=counts)
        return out, None


def bilinear_sample_uv(texture: torch.Tensor, uvs: torch.Tensor) -> torch.Tensor:
    """Bilinear texture lookup at UVs ``[..., 2]`` (OBJ convention: v up).

    A gather from the row-flattened texture; differentiable w.r.t. the
    texture (:class:`_Gather`'s scatter-add) and the UVs.
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
        return _Gather.apply(tex_flat, yi.long() * Tw + xi.long())

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
