"""UV texture fitting: optimise a texture atlas by differentiable rendering.

Counterpart of ``bodyfitting_tpu/fitting/texture.py`` (:36-645).  The
optimised variable is the UV texture image itself, sampled bilinearly
through the rasterizer; the 200-iteration Adam loop (5 cycles over 18
ring views, then random sphere views) minimises the summed L1 between
the scan's render and the SMPL+D render.  Geometry is fixed during the
fit, so by default (``precompute=True``) each unique camera's scan
render, SMPL UV map and coverage are built once through the fused
z-buffer kernel (``rasterize_attrs``), and every Adam step is a gather
from the texture and its scatter-add gradient.

Entry points take numpy arrays (or tensors) and ``device=None``, which
:func:`bodyfitting_torch.default_device` resolves: the card, or a raise
unless the caller passes ``device="cpu"``.  Float inputs keep their
dtype; the kernels take float32.  ``render_compare`` (PNG and mp4 output)
waits for the app.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from bodyfitting_torch.device import default_device
from bodyfitting_torch.fitting.smplify import Adam
from bodyfitting_torch.ops import rasterize as rz
from bodyfitting_torch.ops.kernels import rasterize_attrs


@dataclasses.dataclass(frozen=True)
class TextureFitConfig:
    """The JAX package's texture-fit settings.

    ``precompute`` picks the route: build each unique pose's maps once
    (True) or re-render both meshes at every step (False).  ``bucketed_uv``,
    ``uv_chunk`` and ``uv_window_rows`` exist in the JAX package only to
    turn the sampling gather into one-hot matrix products on the TPU's
    matrix unit (``ops/uv_sample.py``); ``map_chunk`` and ``packed_glue``
    only shape XLA programs; ``face_block`` is the XLA raster's face
    chunk.  The JAX tests show that none of them changes a value
    (``tests/test_texture_precompute.py``).  The port accepts them and
    computes the gather form for every setting.
    """

    tex_img_size: int = 1024
    render_img_size: int = 512
    lr: float = 1e-2
    iter_num: int = 200
    round_views: int = 18
    round_view_iters: int = 5      # cycles over the round views first
    face_block: int = 256
    seed: int = 0
    precompute: bool = True
    bucketed_uv: bool = True
    uv_chunk: int = 2048
    uv_window_rows: int = 8
    map_chunk: int = 32
    packed_glue: bool = False


# ---------------------------------------------------------------------------
# Camera schedules (host-side numpy)
# ---------------------------------------------------------------------------


def look_at_w2c(eye: np.ndarray, center: np.ndarray,
                up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """CV-convention world-to-camera: +z forward (towards center), y down;
    world-up maps to image-up."""
    eye = np.asarray(eye, np.float64)
    z = center - eye
    z = z / np.linalg.norm(z)
    up = np.asarray(up, np.float64)
    x = np.cross(z, up)
    n = np.linalg.norm(x)
    if n < 1e-8:                      # looking straight up/down
        x = np.array([1.0, 0.0, 0.0])
    else:
        x = x / n
    y = np.cross(z, x)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, eye
    return np.linalg.inv(c2w)


def ring_poses(center: np.ndarray, n: int, dist: float) -> np.ndarray:
    """n w2c matrices on a horizontal ring looking at ``center``."""
    out = []
    for theta in np.linspace(0, 2 * np.pi, n + 1)[:-1]:
        eye = center + np.array(
            [np.cos(theta), 0.0, -np.sin(theta)]
        ) * dist
        out.append(look_at_w2c(eye, center))
    return np.stack(out).astype(np.float32)


def sphere_pose(rad: float, theta: float, phi: float,
                center: np.ndarray) -> np.ndarray:
    """A w2c on the sphere of radius ``rad`` about ``center``."""
    eye = center + rad * np.array([
        np.sin(theta) * np.sin(phi), np.cos(theta), np.sin(theta) * np.cos(phi)
    ])
    return look_at_w2c(eye, center).astype(np.float32)


def training_pose_schedule(
    config: TextureFitConfig, center: np.ndarray, dist: float
) -> np.ndarray:
    """[iter_num, 4, 4] per-iteration cameras: ring cycles, then random
    sphere samples."""
    rng = np.random.default_rng(config.seed)
    ring = ring_poses(center, config.round_views, dist)
    poses = []
    for i in range(config.iter_num):
        if i < config.round_view_iters * config.round_views:
            poses.append(ring[i % config.round_views])
        else:
            poses.append(sphere_pose(
                dist, rng.uniform(0, np.pi), rng.uniform(0, 2 * np.pi),
                center,
            ))
    return np.stack(poses)


def default_K(img_size: int) -> np.ndarray:
    """f = img_size, principal point centred."""
    s = float(img_size)
    return np.array(
        [[s, 0, s / 2], [0, s, s / 2], [0, 0, 1]], np.float32
    )


def scene_bounds(verts: np.ndarray):
    """(center, bound, dist) with dist = height / 0.8."""
    vmin, vmax = np.asarray(verts).min(0), np.asarray(verts).max(0)
    center = (vmin + vmax) / 2
    bound = vmax - vmin
    return center, bound, float(bound[1] / 0.8)


# ---------------------------------------------------------------------------
# Rendering helpers
# ---------------------------------------------------------------------------


def _t(x, device, dtype=None) -> torch.Tensor:
    """``x`` (numpy or tensor) as a tensor on ``device``; floats keep their
    dtype unless ``dtype`` is given, integers become int64."""
    t = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                        device=device)
    if dtype is not None:
        return t.to(dtype)
    return t.long() if not t.is_floating_point() else t


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def render_textured(verts, faces, face_uvs, texture, w2c, K, image_size,
                    face_block=256, background=1.0, supersample: int = 1):
    """Rasterize and UV-sample, all tensors on one device; differentiable
    w.r.t. ``texture`` (the raster is a constant).  ``supersample=2``
    renders at twice the size and box-filters down; the returned raster
    stays at the render scale."""
    ss = max(int(supersample), 1)
    K_ss = K
    if ss > 1:
        # scale fx/fy/cx/cy but keep K[2,2] = 1
        K_ss = K * ss
        K_ss[2, 2] = 1.0
    px, fz = rz.project_faces(verts, faces, w2c, K_ss)
    raster = rz.rasterize(px.detach(), fz.detach(), image_size * ss,
                          face_block=face_block)
    raster = rz.RasterOut(*(t.detach() for t in raster))
    img = rz.sample_texture(raster, face_uvs, texture, background=background)
    if ss > 1:
        H = image_size
        img = img.reshape(H, ss, H, ss, -1).mean(dim=(1, 3))
    return img, raster


def render_scan_views(
    scan_verts, scan_faces, scan_face_uvs, scan_texture,
    imgsize: int = 512, viewnum: int = 8, white_bkgd: bool = False,
    face_block: int = 512, device=None,
):
    """Ring-view synthetic images and masks of a textured scan (the
    multi-view input of RenderPeople fitting).  Returns ``(images
    [N, H, W, 3] uint8, masks [N, H, W] uint8, w2cs, Ks)`` as numpy; the
    images are clipped to [0, 1], scaled by 255 and truncated."""
    device = default_device(device)
    center, _, dist = scene_bounds(_numpy(scan_verts))
    w2cs = ring_poses(center, viewnum, dist)
    K = default_K(imgsize)
    sv, sf = _t(scan_verts, device), _t(scan_faces, device)
    su, st = _t(scan_face_uvs, device), _t(scan_texture, device)
    Kt = _t(K, device)
    bg = 1.0 if white_bkgd else 0.0
    imgs, masks = [], []
    with torch.no_grad():
        for i in range(viewnum):
            img, raster = render_textured(
                sv, sf, su, st, _t(w2cs[i], device), Kt, int(imgsize),
                face_block=face_block, background=bg)
            mask = rz.render_silhouette(raster)
            imgs.append((torch.clamp(img, 0.0, 1.0) * 255).to(torch.uint8))
            masks.append((mask * 255).to(torch.uint8))
    imgs = torch.stack(imgs).cpu().numpy()
    masks = torch.stack(masks).cpu().numpy()
    Ks = np.stack([K] * viewnum)
    return imgs, masks, w2cs, Ks


# ---------------------------------------------------------------------------
# The texture optimisation itself
# ---------------------------------------------------------------------------


def texture_maps(poses, K, scene, img_size: int):
    """Per pose of ``poses [N, 4, 4]``: the scan's render (white
    background) and the SMPL mesh's UV map and coverage, each through one
    ``rasterize_attrs`` launch.  ``scene`` is ``(scan_v, scan_f, scan_uv,
    scan_tex, smpl_v, smpl_f, smpl_uv)`` on one device.  Returns
    ``(scan_imgs [N, H, W, 3], uv_maps [N, H, W, 2], fgs [N, H, W]
    bool)``."""
    scan_v, scan_f, scan_uv, scan_t, smpl_v, smpl_f, smpl_uv = scene
    scan_imgs, uv_maps, fgs = [], [], []
    with torch.no_grad():
        for w2c in poses:
            s_px, s_fz = rz.project_faces(scan_v, scan_f, w2c, K)
            s_uv, s_fidx, _ = rasterize_attrs(s_px, s_fz, scan_uv, img_size)
            scan_imgs.append(rz.sample_texture_uvmap(
                s_uv, s_fidx >= 0, scan_t, background=1.0))
            px, fz = rz.project_faces(smpl_v, smpl_f, w2c, K)
            uv_map, fidx, _ = rasterize_attrs(px, fz, smpl_uv, img_size)
            uv_maps.append(uv_map)
            fgs.append(fidx >= 0)
    return torch.stack(scan_imgs), torch.stack(uv_maps), torch.stack(fgs)


def maps_loss(tex, scan_img, uv_map, fg):
    """Summed L1 between a scan render and the SMPL render sampled from
    ``tex`` through a cached UV map (white background)."""
    smpl_img = rz.sample_texture_uvmap(uv_map, fg, tex, background=1.0)
    return torch.abs(scan_img - smpl_img).sum()


def adam_loop(lr, loss_fn, tex0, xs):
    """Adam over ``xs`` (``optax.adam(lr)``: ``scale_by_adam`` and a step
    of ``-lr``), the texture clipped to [0, 1] after each step.  Returns
    ``(texture, losses [len(xs)])``; the loss is taken before the step."""
    tex = tex0.detach().clone()
    opt = Adam([tex], [lr])
    losses = tex.new_empty((len(xs),))
    for i, x in enumerate(xs):
        t = tex.detach().requires_grad_(True)
        loss = loss_fn(t, x)
        (g,) = torch.autograd.grad(loss, [t])
        losses[i] = loss.detach()
        opt.step([g])
        tex.clamp_(0.0, 1.0)
    return tex, losses


def fit_texture(
    smpl_verts,
    smpl_faces,
    smpl_face_uvs,
    scan_verts,
    scan_faces,
    scan_face_uvs,
    scan_texture,
    config: TextureFitConfig = TextureFitConfig(),
    init_texture: Optional[np.ndarray] = None,
    device=None,
):
    """Optimise the SMPL(+D) UV texture to match scan renders.

    Returns ``(texture [S, S, 3], per-iteration losses)`` as tensors on
    ``device``.  The default texture is grey (128/255).  The precompute
    route deduplicates the pose schedule and builds each unique pose's
    maps once (:func:`texture_maps`: two ``rasterize_attrs`` launches a
    pose); ``precompute=False`` re-renders both meshes at every step
    (two ``rasterize_zbuf`` launches a step).
    """
    device = default_device(device)
    center, _, dist = scene_bounds(_numpy(scan_verts))
    poses_np = training_pose_schedule(config, center, dist)
    K = _t(default_K(config.render_img_size), device)

    S = config.tex_img_size
    smpl_v = _t(smpl_verts, device)
    if init_texture is None:
        init_texture = torch.full((S, S, 3), 128.0 / 255.0,
                                  dtype=smpl_v.dtype, device=device)
    tex0 = _t(init_texture, device)
    scene = (_t(scan_verts, device), _t(scan_faces, device),
             _t(scan_face_uvs, device), _t(scan_texture, device),
             smpl_v, _t(smpl_faces, device), _t(smpl_face_uvs, device))

    if config.precompute:
        uniq, pose_index = np.unique(
            poses_np.reshape(len(poses_np), -1), axis=0, return_inverse=True)
        uniq_poses = _t(uniq.reshape(-1, 4, 4).astype(np.float32), device)
        scan_imgs, uv_maps, fgs = texture_maps(
            uniq_poses, K, scene, config.render_img_size)
        return adam_loop(
            config.lr,
            lambda t, k: maps_loss(t, scan_imgs[k], uv_maps[k], fgs[k]),
            tex0, [int(k) for k in np.asarray(pose_index).reshape(-1)])

    scan_v, scan_f, scan_uv, scan_t, _, smpl_f, smpl_uv = scene
    img_size, fb = config.render_img_size, config.face_block

    def reraster_loss(t, w2c):
        scan_img, _ = render_textured(scan_v, scan_f, scan_uv, scan_t, w2c,
                                      K, img_size, fb)
        smpl_img, _ = render_textured(smpl_v, smpl_f, smpl_uv, t, w2c, K,
                                      img_size, fb)
        return torch.abs(scan_img.detach() - smpl_img).sum()

    poses = _t(poses_np, device)
    return adam_loop(config.lr, reraster_loss, tex0, list(poses))


# ---------------------------------------------------------------------------
# The atlas: coverage, displacement baking, hole fill, inpainting
# ---------------------------------------------------------------------------


def rasterize_uv_atlas(face_uvs, tex_img_size: int, face_block: int = 256,
                       device=None) -> rz.RasterOut:
    """Rasterize UV triangles ``[F, 3, 2]`` in atlas space (v up -> texel
    row 0 = top, the mapping of ``sample_texture``), one ``rasterize_zbuf``
    launch.  Shared by the coverage mask and displacement baking."""
    device = default_device(device)
    fu = _t(face_uvs, device)
    S = tex_img_size
    px = torch.stack([fu[..., 0] * (S - 1), (1.0 - fu[..., 1]) * (S - 1)],
                     dim=-1)
    fz = torch.ones(fu.shape[:2], dtype=fu.dtype, device=device)
    return rz.rasterize(px, fz, S, face_block=face_block)


def atlas_coverage_mask(face_uvs, tex_img_size: int, face_block: int = 256,
                        device=None) -> torch.Tensor:
    """``[S, S]`` float mask of texels covered by any UV triangle."""
    raster = rasterize_uv_atlas(face_uvs, tex_img_size, face_block, device)
    return rz.render_silhouette(raster)


def bake_displacement_map(face_uvs, faces, displacement, tex_img_size: int,
                          face_block: int = 256, raster=None, device=None):
    """Bake per-vertex values ``displacement [V, C]`` (SMPL+D offsets)
    into a UV-space map by barycentric interpolation over the atlas raster
    (``raster``: a :func:`rasterize_uv_atlas` output, else one is made).
    Returns ``(map [S, S, C], coverage [S, S])``."""
    device = default_device(device)
    if raster is None:
        raster = rasterize_uv_atlas(face_uvs, tex_img_size, face_block,
                                    device)
    corner = _t(displacement, device)[_t(faces, device)]        # [F, 3, C]
    return rz.render_attributes(raster, corner), rz.render_silhouette(raster)


def displacement_map_to8b(dis_map, coverage) -> np.ndarray:
    """Signed displacement map -> uint8 image, 0.5 = zero displacement,
    scaled by the RMS displacement about zero over the covered texels."""
    dis = _numpy(dis_map).astype(np.float32)
    cov = _numpy(coverage) > 0.5
    if cov.any():
        rms = np.sqrt((dis[cov].reshape(-1, 3) ** 2).mean(0)) + 1e-9
    else:
        rms = np.ones(3, np.float32)
    img = 0.5 + dis / (6.0 * rms)
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


def fill_texture_holes(texture, coverage, iterations: int = 1) -> np.ndarray:
    """Erode/dilate seam fill: texels just outside the covered atlas (and
    everything uncovered) take the 3x3-eroded texture, covered texels keep
    theirs.

    The JAX package uses OpenCV, which the card's machine lacks.
    ``cv2.erode`` with a 3x3 kernel and its default border (outside texels
    ignored) is ``grey_erosion(size=(3, 3, 1), mode="nearest")`` per
    channel; ``cv2.dilate`` of the 0/1 mask is ``binary_dilation`` with a
    3x3 structure; the blend keeps the JAX expression and dtypes.
    """
    from scipy import ndimage

    img = _numpy(texture)
    valid = (_numpy(coverage) > 0.5).astype(np.uint8)[..., None]
    square = np.ones((3, 3), bool)
    valid_d = ndimage.binary_dilation(valid[..., 0], structure=square,
                                      iterations=iterations)
    valid_d = valid_d.astype(np.uint8)[..., None]
    img_e = img
    for _ in range(iterations):
        img_e = ndimage.grey_erosion(img_e, size=(3, 3, 1), mode="nearest")
    return (valid_d - valid) * img_e + valid * img + (1 - valid_d) * img_e


def inpaint_unseen(texture, unseen_mask, iterations: int = 200,
                   device=None) -> np.ndarray:
    """Diffusion inpainting of unseen atlas regions: repeated 4-neighbour
    averaging (wrapping at the borders) propagates seen colours into the
    masked texels.  Runs on ``device`` in float32 with the JAX package's
    operations in its order (``np.roll``, left-to-right sums, a division
    by 4), so the result equals the numpy one bit for bit; returns numpy.
    """
    device = default_device(device)
    img = _t(texture, device, torch.float32)
    m = _t(unseen_mask, device).bool()[..., None]
    if not bool(m.any()):
        return img.cpu().numpy()
    for _ in range(iterations):
        blur = (
            torch.roll(img, 1, 0) + torch.roll(img, -1, 0)
            + torch.roll(img, 1, 1) + torch.roll(img, -1, 1)
        ) / 4.0
        img = torch.where(m, blur, img)
    return img.cpu().numpy()
