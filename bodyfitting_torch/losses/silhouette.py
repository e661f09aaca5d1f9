"""Silhouette (mask) fitting loss, batched over frames and views.

Counterpart of ``bodyfitting_tpu/losses/silhouette.py`` (its separate-op
form; the fused per-view op is not ported).  Two terms per mask view:

  * contour -> model 2D ICP: each contour pixel's distance to the nearest
    projected vertex that lands inside the image, weighted ``epsilon`` x
    when the matched vertex's pixel lies outside the mask.  The match is
    :func:`~bodyfitting_torch.ops.kernels.contour_match_full` and its
    gradient :func:`~bodyfitting_torch.ops.kernels.rows_scatter_add`;
  * "stay inside": ``1 - mask`` bilinearly sampled (torch-1.2
    ``grid_sample`` taps, align_corners=True, zero padding) at every
    projected vertex, computed as ``coverage - sample`` through
    :func:`~bodyfitting_torch.ops.kernels.bilinear_cov_grads`.

Frames ``B`` and mask views ``Vm`` are flattened into one kernel batch
axis ``BV = B * Vm``.  Host-side preparation (binarising, contour
extraction and resampling, content crops) is numpy, without OpenCV.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from bodyfitting_torch.ops.camera import perspective_projection
from bodyfitting_torch.ops.kernels import (
    bilinear_cov_grads,
    contour_match_full,
    pack_bits,
    rows_scatter_add,
)

# ---------------------------------------------------------------------------
# Host-side preparation
# ---------------------------------------------------------------------------


def binarize_mask(mask: np.ndarray) -> np.ndarray:
    """0/1 float32 from a binary/float/uint8 mask: values on a [0, 255]
    scale threshold at 127.5, values on a [0, 1] scale at 0.5."""
    m = np.asarray(mask)
    thr = 127.5 if m.max(initial=0.0) > 1.0 else 0.5
    return (m > thr).astype(np.float32)


# Suzuki-Abe neighbour codes as OpenCV numbers them: 0 = right, then
# counter-clockwise on screen (y grows downwards).
_DY = (0, -1, -1, -1, 0, 1, 1, 1)
_DX = (1, 1, 0, -1, -1, -1, 0, 1)


def _trace_outer_border(img: np.ndarray, y0: int, x0: int) -> list:
    """Outer border of the 8-connected component whose raster-first pixel
    is ``(y0, x0)``, every border pixel in order (Suzuki-Abe border
    following as OpenCV's ``CHAIN_APPROX_NONE`` emits it: from the start
    pixel down the component's left side).  ``img`` is a 0/1 array with
    a zero frame around the content."""
    s = 4
    while True:
        s = (s - 1) & 7
        if img[y0 + _DY[s], x0 + _DX[s]] or s == 4:
            break
    if s == 4:                      # isolated pixel
        return [(x0, y0)]
    y1, x1 = y0 + _DY[s], x0 + _DX[s]
    y3, x3 = y0, x0
    pts = []
    while True:
        for k in range(s + 1, s + 9):
            d = k & 7
            y4, x4 = y3 + _DY[d], x3 + _DX[d]
            if img[y4, x4]:
                s = d
                break
        pts.append((x3, y3))
        if (y4, x4) == (y0, x0) and (y3, x3) == (y1, x1):
            return pts
        y3, x3 = y4, x4
        s = (s + 4) & 7


def _outer_contours(binary: np.ndarray) -> list:
    """Every outermost contour of a 0/1 mask as ``[n, 2]`` (x, y) arrays,
    in the order OpenCV's ``findContours(RETR_EXTERNAL)`` returns them
    (raster order of discovery, reversed)."""
    from scipy import ndimage

    filled = ndimage.binary_fill_holes(binary > 0)
    labels, n = ndimage.label(filled, structure=np.ones((3, 3), bool))
    if n == 0:
        return []
    flat = labels.ravel()
    nz = np.flatnonzero(flat)
    _, first = np.unique(flat[nz], return_index=True)
    starts = sorted(nz[first])                 # raster order of discovery
    W = binary.shape[1]
    padded = np.pad(filled, 1).astype(np.uint8)
    out = []
    for s in starts:
        y, x = divmod(int(s), W)
        pts = _trace_outer_border(padded, y + 1, x + 1)
        out.append(np.asarray(pts, np.float32) - 1.0)
    return out[::-1]


def extract_contours(
    masks: Sequence[np.ndarray], pad_to: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side outer-contour extraction without OpenCV.

    For each mask, the largest outer contour (most border pixels; the
    first of equals in OpenCV's order), exactly as the JAX package's
    ``cv2.findContours(RETR_EXTERNAL, CHAIN_APPROX_NONE)`` route picks it.

    Returns ``(contours [Vm, P, 2] float32 (x, y), valid [Vm, P]
    float32)``, padded or truncated to ``pad_to`` (default: longest).
    """
    pts_list = []
    for mask in masks:
        contours = _outer_contours(binarize_mask(mask))
        if not contours:
            pts_list.append(np.zeros((0, 2), np.float32))
            continue
        pts_list.append(
            contours[int(np.argmax([c.shape[0] for c in contours]))]
        )

    P = pad_to or max(p.shape[0] for p in pts_list)
    out = np.zeros((len(pts_list), P, 2), np.float32)
    valid = np.zeros((len(pts_list), P), np.float32)
    for i, p in enumerate(pts_list):
        n = min(p.shape[0], P)
        out[i, :n] = p[:n]
        valid[i, :n] = 1.0
    return out, valid


def resample_contours(
    contours: np.ndarray,
    valid: np.ndarray,
    num_points: int = 512,
) -> tuple[np.ndarray, np.ndarray]:
    """Arc-length-uniform resampling of padded contours (host-side).

    Contours longer than ``num_points`` are resampled to exactly that
    many points with weights ``n_original / num_points`` (folded into the
    validity), so the ICP term keeps the pixel-sum magnitude of the full
    contour.  Shorter contours are kept as they are with weight 1.
    """
    Vm = contours.shape[0]
    out = np.zeros((Vm, num_points, 2), np.float32)
    weights = np.zeros((Vm, num_points), np.float32)
    for i in range(Vm):
        pts = contours[i][valid[i] > 0]
        n = pts.shape[0]
        if n == 0:
            continue
        if n <= num_points:
            out[i, :n] = pts
            weights[i, :n] = 1.0
            continue
        closed = np.concatenate([pts, pts[:1]], axis=0)
        seg = np.linalg.norm(np.diff(closed, axis=0), axis=1)
        arc = np.concatenate([[0.0], np.cumsum(seg)])
        total = arc[-1]
        targets = np.linspace(0.0, total, num_points, endpoint=False)
        seg_idx = np.clip(
            np.searchsorted(arc, targets, side="right") - 1, 0, n - 1
        )
        t = (targets - arc[seg_idx]) / np.maximum(seg[seg_idx], 1e-9)
        out[i] = (
            closed[seg_idx] * (1.0 - t[:, None])
            + closed[seg_idx + 1] * t[:, None]
        )
        weights[i] = n / float(num_points)
    return out, weights


def compute_mask_crops(
    masks: Sequence[np.ndarray],
    crop_hw: tuple | None = None,
    margin: int = 2,
) -> tuple[np.ndarray, np.ndarray, tuple]:
    """Content crops for the stay-inside term (host-side).

    Every nonzero pixel plus a ``margin`` of zeros lies inside the crop,
    so sampling the crop equals sampling the full mask.  ``crop_hw``
    fixes the shape (shared across a frame batch); None picks the
    smallest fit rounded up to (8, 128) multiples, as the JAX package
    does, so both packages crop identically.

    Returns ``(crops [Vm, Hc, Wc] float32, origins [Vm, 2] float32
    (x0, y0), (Hc, Wc))``; raises ValueError when content + margin does
    not fit ``crop_hw``.
    """
    bins = [binarize_mask(m) for m in masks]
    H, W = bins[0].shape
    boxes = []
    for b in bins:
        ys, xs = np.nonzero(b)
        if ys.size == 0:
            boxes.append((0, 1, 0, 1))
        else:
            boxes.append((int(ys.min()), int(ys.max()) + 1,
                          int(xs.min()), int(xs.max()) + 1))
    need_h = max(y1 - y0 for y0, y1, _, _ in boxes) + 2 * margin
    need_w = max(x1 - x0 for _, _, x0, x1 in boxes) + 2 * margin
    if crop_hw is None:
        Hc = min(H, int(-(-need_h // 8) * 8))
        Wc = min(W, int(-(-need_w // 128) * 128))
    else:
        Hc, Wc = crop_hw
        if (need_h > Hc and Hc < H) or (need_w > Wc and Wc < W):
            raise ValueError(
                f"mask content {need_h}x{need_w} exceeds crop {Hc}x{Wc}"
            )
    crops = np.zeros((len(bins), Hc, Wc), np.float32)
    origins = np.zeros((len(bins), 2), np.float32)
    for i, (b, (y0, y1, x0, x1)) in enumerate(zip(bins, boxes)):
        oy = min(max(y0 - margin, 0), H - Hc)
        ox = min(max(x0 - margin, 0), W - Wc)
        crops[i] = b[oy:oy + Hc, ox:ox + Wc]
        origins[i] = (ox, oy)
    return crops, origins, (Hc, Wc)


def mask_crops_bits(crops: torch.Tensor) -> torch.Tensor:
    """The 0/1 mask crops ``[..., Hc, Wc]`` as a bit mask ``[..., Hc,
    ceil(Wc / 32)]`` (:func:`~bodyfitting_torch.ops.kernels.bilinear.
    pack_bits`), the type the sampler reads on the main path: 1/32 of the
    f32 bytes, and a mask bit converts to float exactly, so the loss
    keeps its bits.  The zero columns that pad ``Wc`` to a multiple of 32
    sample as the zeros outside the crop do (the loss samples crops
    without coverage).  Made once a fit
    (``fitting/smplify.py:step_observations``); raises ValueError if a
    value is neither 0 nor 1."""
    if not bool(((crops == 0) | (crops == 1)).all()):
        raise ValueError("mask crops must hold only 0 and 1 to be sampled "
                         "as a bit mask")
    return pack_bits(crops)


# ---------------------------------------------------------------------------
# Differentiable pieces
# ---------------------------------------------------------------------------


def coverage_closed_form(xyhat: torch.Tensor, full_hw: tuple) -> torch.Tensor:
    """Per-point in-image coverage: the zero-padded bilinear sample of a
    constant-1 ``[H, W]`` image at pixel-grid position ``xyhat [..., 2]``,
    ``clip(min(y + 1, H - y), 0, 1) * clip(min(x + 1, W - x), 0, 1)``."""
    cov, _, _ = _coverage_and_grads(xyhat, full_hw)
    return cov


def _coverage_and_grads(xyhat: torch.Tensor, full_hw: tuple):
    """Closed-form coverage and its analytic x/y derivatives (+-1 on the
    open one-pixel border ramps, 0 elsewhere).  Returns
    ``(cov, dcov_dx, dcov_dy)``."""
    H, W = full_hw
    x, y = xyhat[..., 0], xyhat[..., 1]

    def axis_cov(v, n):
        lo = v + 1.0
        hi = float(n) - v
        c = torch.clamp(torch.minimum(lo, hi), 0.0, 1.0)
        on_ramp = (c > 0.0) & (c < 1.0)
        slope = torch.where(lo < hi, 1.0, -1.0).to(v.dtype)
        return c, torch.where(on_ramp, slope, 0.0)

    rs, drs = axis_cov(y, H)
    cs, dcs = axis_cov(x, W)
    return rs * cs, dcs * rs, drs * cs


class StayInsideSampleCrop(torch.autograd.Function):
    """``(sample, coverage)`` on a content crop: the sample from
    :func:`bilinear_cov_grads` at the crop-relative position, the
    coverage in closed form against the full image bounds.

    Inputs ``crop [BV, Hc, Wc]``, ``xyhat [BV, N, 2]`` (full-image
    pixel-grid units), ``origin [BV, 2]``, ``full_hw``.  Only ``xyhat``
    gets a gradient: masks and origins are observations.  The kernel's
    forward already returns the positional derivatives, so the backward
    is elementwise.
    """

    @staticmethod
    def forward(ctx, crop, xyhat, origin, full_hw):
        xyc = (xyhat - origin[:, None, :]).contiguous()
        out = bilinear_cov_grads(crop, xyc, with_grads=True, with_cov=False)
        cov, dc_dx, dc_dy = _coverage_and_grads(xyhat, full_hw)
        ctx.save_for_backward(out[:, 2], out[:, 3], dc_dx, dc_dy)
        return out[:, 0], cov

    @staticmethod
    def backward(ctx, gs, gc):
        ds_dx, ds_dy, dc_dx, dc_dy = ctx.saved_tensors
        gx = gs * ds_dx + gc * dc_dx
        gy = gs * ds_dy + gc * dc_dy
        return None, torch.stack([gx, gy], dim=-1), None, None


class StayInsideSample(torch.autograd.Function):
    """``(sample, coverage)`` on full masks ``[BV, H, W]``: both from one
    :func:`bilinear_cov_grads` call with coverage and derivatives."""

    @staticmethod
    def forward(ctx, img, xyhat):
        out = bilinear_cov_grads(img, xyhat.contiguous(), with_grads=True,
                                 with_cov=True)
        ctx.save_for_backward(out[:, 2], out[:, 3], out[:, 4], out[:, 5])
        return out[:, 0], out[:, 1]

    @staticmethod
    def backward(ctx, gs, gc):
        ds_dx, ds_dy, dc_dx, dc_dy = ctx.saved_tensors
        gx = gs * ds_dx + gc * dc_dx
        gy = gs * ds_dy + gc * dc_dy
        return None, torch.stack([gx, gy], dim=-1)


class ContourMatched(torch.autograd.Function):
    """``(matched [BV, P, 2], in_match [BV, P])``: each contour pixel's
    nearest candidate among the projected vertices ``proj [BV, M, 2]``
    whose ``inside_f [BV, M]`` flag is set.  The argmin carries no
    gradient; ``d matched / d proj`` is a row selection, whose backward
    :func:`rows_scatter_add` sums the cotangent rows back onto the
    winning vertices."""

    @staticmethod
    def forward(ctx, contour, proj, inside_f):
        _, idx, matched, in_match = contour_match_full(
            contour, proj.detach().contiguous(), inside_f, inside_f
        )
        ctx.save_for_backward(idx)
        ctx.num_candidates = proj.shape[1]
        ctx.mark_non_differentiable(in_match)
        return matched, in_match

    @staticmethod
    def backward(ctx, g_matched, _g_in):
        (idx,) = ctx.saved_tensors
        dproj = rows_scatter_add(idx, g_matched.contiguous(),
                                 ctx.num_candidates)
        return None, dproj.transpose(1, 2), None


# ---------------------------------------------------------------------------
# The loss
# ---------------------------------------------------------------------------


def silhouette_loss(
    contours: torch.Tensor,
    contour_valid: torch.Tensor,
    masks: torch.Tensor | None,
    w2cs: torch.Tensor,
    Ks: torch.Tensor,
    verts: torch.Tensor,
    *,
    vertex_stride: int = 4,
    epsilon: float = 10.0,
    imsize: float = 512.0,
    mask_crops: torch.Tensor | None = None,
    mask_crop_origins: torch.Tensor | None = None,
    mask_view_valid: torch.Tensor | None = None,
    full_hw: tuple | None = None,
) -> torch.Tensor:
    """Multi-view mask loss per frame, ``[B]``.

    Args:
      contours ``[B, Vm, P, 2]`` padded contour pixels (x, y);
      contour_valid ``[B, Vm, P]`` contour weights (0 = padding);
      masks ``[B, Vm, H, W]`` 0/1 masks (full-mask mode; padded views
        all-ones), or None in crop mode;
      w2cs ``[B, Vm, 4, 4]``, Ks ``[B, Vm, 3, 3]``;
      verts ``[B, V, 3]`` world vertices (already scaled).

    Crop mode (``mask_crops [B, Vm, Hc, Wc]`` + ``mask_crop_origins
    [B, Vm, 2]``, from :func:`compute_mask_crops`): the mask is sampled on
    the crops, the coverage is closed-form against ``full_hw`` (default
    ``(imsize, imsize)``) and padded views are zeroed by
    ``mask_view_valid [B, Vm]``.
    """
    use_crops = mask_crops is not None
    B, Vm = w2cs.shape[:2]
    BV = B * Vm
    pts3d = verts[:, ::vertex_stride]
    proj = perspective_projection(
        pts3d[:, None], w2cs[..., :3, :3], w2cs[..., :3, 3], Ks
    ).reshape(BV, -1, 2)                                      # [BV, M, 2]
    if use_crops:
        H, W = full_hw if full_hw is not None else (int(imsize), int(imsize))
        look_img = mask_crops.reshape(BV, *mask_crops.shape[2:])
        origin = mask_crop_origins.reshape(BV, 2)
        vvalid = (
            mask_view_valid.reshape(BV) if mask_view_valid is not None
            else proj.new_ones(BV)
        )
    else:
        H, W = masks.shape[-2:]
        look_img = masks.reshape(BV, H, W)
    contour = contours.reshape(BV, -1, 2)
    cvalid = contour_valid.reshape(BV, -1)

    # contour -> model ICP over the vertices that project inside the image
    px, py = proj[..., 0], proj[..., 1]
    inside_f = ((px >= 0) & (px < imsize) & (py >= 0)
                & (py < imsize)).to(proj.dtype)
    matched, in_match = ContourMatched.apply(contour, proj, inside_f)
    dist = torch.sqrt(torch.sum((contour - matched) ** 2, dim=-1) + 1e-12)
    # no strided vertex inside this view: nothing to match, term dropped
    mindist = torch.where(in_match > 0.5, dist, 0.0)
    with torch.no_grad():
        mx = matched[..., 0].to(torch.int32).clamp(0, W - 1)
        my = matched[..., 1].to(torch.int32).clamp(0, H - 1)
        mxy = torch.stack([mx, my], dim=-1).to(proj.dtype)
        if use_crops:
            mxy = mxy - origin[:, None, :]
        # bilinear at integer pixels is the pixel's value exactly
        mask_at = bilinear_cov_grads(look_img, mxy.contiguous(),
                                     with_grads=False, with_cov=False)[:, 0]
        coeff = torch.where(mask_at < 0.1, epsilon, 1.0).to(proj.dtype)
    icp = torch.sum(mindist * coeff * cvalid, dim=-1)         # [BV]

    # differentiable stay-inside term: sum of (1 - mask) at the vertices
    scale = torch.tensor([(W - 1) / imsize, (H - 1) / imsize],
                         dtype=proj.dtype, device=proj.device)
    xyhat = proj * scale
    if use_crops:
        sampled, coverage = StayInsideSampleCrop.apply(
            look_img, xyhat, origin, (H, W)
        )
        binary = vvalid * torch.sum(coverage - sampled, dim=-1)
    else:
        sampled, coverage = StayInsideSample.apply(look_img, xyhat)
        binary = torch.sum(coverage - sampled, dim=-1)
    return (icp.reshape(B, Vm).sum(dim=1)
            + binary.reshape(B, Vm).sum(dim=1) * epsilon)
