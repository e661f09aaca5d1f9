"""Debug overlays: a fitted mesh shaded over a camera image.

Counterpart of ``bodyfitting_tpu/utils/overlay.py``: the mesh is
projected (``ops.rasterize.project_faces``), z-buffered (the
``rasterize_zbuf`` kernel on a CUDA device; the shading needs only the
winning face, so no barycentrics are computed) and flat-shaded by each
face's camera-space normal, then blended over the image.  All of it
runs on ``device`` in float32; the uint8 result is copied to the host
once.
"""

from __future__ import annotations

import numpy as np
import torch

from bodyfitting_torch.device import default_device


def render_mesh_overlay(image: np.ndarray, verts, faces, w2c, K,
                        color=(0.65, 0.74, 0.86), alpha: float = 0.8,
                        light_dir=(0.0, 0.0, 1.0), ambient: float = 0.45,
                        device=None) -> np.ndarray:
    """Shade the mesh (Lambertian, double-sided, a camera-space light) and
    blend it over ``image`` (uint8 ``[H, W, 3]``): uint8 ``[H, W, 3]``.

    The rasterizer is square: it renders ``max(H, W)`` squared and keeps
    ``[:H, :W]`` (pixel coordinates are absolute, so that is the image's
    window).  On ``device`` (default ``cuda``; raises without a card)."""
    from bodyfitting_torch.losses.mesh import compute_face_normals
    from bodyfitting_torch.ops import kernels
    from bodyfitting_torch.ops import rasterize as rz

    device = default_device(device)
    H, W = image.shape[:2]

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32) if not
                               torch.is_tensor(a) else a,
                               dtype=torch.float32, device=device)

    verts, w2c, K = f32(verts), f32(w2c), f32(K)
    faces = torch.as_tensor(np.asarray(faces) if not torch.is_tensor(faces)
                            else faces, device=device).long()
    px, fz = rz.project_faces(verts, faces, w2c, K)
    _, fidx = kernels.rasterize_zbuf(px, fz, max(H, W))
    fidx = fidx[:H, :W]

    fn = compute_face_normals(verts, faces) @ w2c[:3, :3].T
    fn = fn / torch.clamp(torch.linalg.norm(fn, dim=-1, keepdim=True),
                          min=1e-12)
    light = f32(light_dir)
    light = light / torch.linalg.norm(light)
    diffuse = (fn @ light).abs()                  # double-sided shading
    intensity = torch.clamp(ambient + (1 - ambient) * diffuse, 0.0, 1.0)
    shade = intensity[torch.clamp(fidx, min=0).long()]
    mesh_rgb = shade[..., None] * f32(color)

    img = torch.as_tensor(np.ascontiguousarray(image),
                          device=device).to(torch.float32) / 255.0
    fg = (fidx >= 0)[..., None]
    out = torch.where(fg, alpha * mesh_rgb + (1 - alpha) * img, img)
    return torch.clamp(out * 255.0, 0, 255).to(torch.uint8).cpu().numpy()


def render_fit_overlays(images, result: dict, faces, c2ws, Ks,
                        skip: int = 12, device=None) -> list:
    """The overlays of a fitted frame on every ``skip``-th view (the
    reference's cadence): a list of ``(view index, uint8 image)``.
    ``result["vertices"]`` is ``[V, 3]`` (numpy or a tensor)."""
    verts = result["vertices"]
    out = []
    for i in range(0, len(images), skip):
        w2c = np.linalg.inv(np.asarray(c2ws[i]))
        out.append((i, render_mesh_overlay(images[i], verts, faces, w2c,
                                           Ks[i], device=device)))
    return out
