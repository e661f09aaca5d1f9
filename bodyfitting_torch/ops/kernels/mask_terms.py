"""The fused per-view mask term: both silhouette terms of every view.

Port of the JAX package's fused route, the custom VJP
``_mask_view_terms_fused`` (``bodyfitting_tpu/losses/silhouette.py:589``,
forward :606, backward :615), whose forward reaches the TPU kernels of
:func:`bilinear_cov_grads` and :func:`contour_match_full` and whose
backward reaches :func:`rows_scatter_add`.  The CUDA kernels are
``ops/csrc/mask_terms.cu`` (forward: two launches for all ``BV`` views;
backward: one), which share their per-point device code with those three
kernels (``ops/csrc/silhouette.cuh``).  The plain versions here are built
from the three kernels' plain versions and the JAX algebra, with every
per-point quantity rounded as the kernels round it and every per-view sum
taken in the kernels' order (:func:`tree_sum`), so the two agree bitwise.

``losses/silhouette.py:MaskViewTerms`` is the autograd function over
them; ``FUSED_MASK_TERM = "fused"`` selects it.
"""

from __future__ import annotations

import functools

import torch

from bodyfitting_torch.ops.kernels import _build
from bodyfitting_torch.ops.kernels.bilinear import bilinear_cov_grads_plain
from bodyfitting_torch.ops.kernels.contour_match import (
    contour_match_full_plain,
)
from bodyfitting_torch.ops.kernels.rows_scatter import (
    MAX_M,
    rows_scatter_add_plain,
)

_SYMBOLS = {torch.float32: "mask_terms_forward_f32",
            torch.int32: "mask_terms_forward_b1"}

FORWARD_GEOMETRY_KEYS = ("blocks", "threads", "smem_bytes", "sum_blocks",
                         "sum_threads")
# The floats a view's two tree sums hold in shared memory on the card
# (half the padded P and M): 48 KB, what a block has without opting in.
SUM_SHARED = 12288


@functools.lru_cache(maxsize=None)
def pixel_scale(full_hw: tuple, imsize: float, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """``((W - 1) / imsize, (H - 1) / imsize)`` in ``dtype`` on ``device``:
    projected pixels to the pixel grid of the full ``(H, W)`` image.  Made
    once for each set of arguments (no host-to-device copy a step)."""
    H, W = full_hw
    return torch.tensor([(W - 1) / imsize, (H - 1) / imsize], dtype=dtype,
                        device=device)


def coverage_and_grads(xyhat: torch.Tensor, full_hw: tuple):
    """Closed-form in-image coverage of pixel-grid positions ``xyhat
    [..., 2]`` against the full ``(H, W)`` image, the zero-padded bilinear
    sample of a constant-1 image, ``clip(min(y + 1, H - y), 0, 1) *
    clip(min(x + 1, W - x), 0, 1)``, and its analytic x/y derivatives
    (+-1 on the open one-pixel border ramps, 0 elsewhere).  Returns
    ``(cov, dcov_dx, dcov_dy)``; NaN propagates."""
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


def _half(n: int) -> int:
    """Half the padded length of a tree sum over ``n`` values (0 for
    ``n <= 1``): the shared floats its tree needs on the card."""
    return 0 if n <= 1 else 1 << (n - 1).bit_length() - 1


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the kernels' order: ``x`` padded with
    zeros to the next power of two, then its halves added, ``x[..., :h] +
    x[..., h:]``, until one value is left."""
    n = x.shape[-1]
    if n <= 1:
        return x[..., 0] if n else x.new_zeros(x.shape[:-1])
    h = _half(n)
    x = x[..., :h] + torch.nn.functional.pad(x[..., h:], (0, 2 * h - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def mask_terms_forward_plain(proj, contour, cvalid, crop, origin, vvalid,
                             imsize: float, epsilon: float, full_hw: tuple):
    """PyTorch version of :func:`mask_terms_forward` (any dtype/device)."""
    H, W = full_hw
    scale = pixel_scale(tuple(full_hw), float(imsize), proj.dtype,
                        proj.device)
    xyhat = proj * scale

    # stay-inside: the sample on the crop, the coverage in closed form
    s = bilinear_cov_grads_plain(crop, xyhat - origin[:, None, :],
                                 with_grads=True, with_cov=False)
    cov, dc_dx, dc_dy = coverage_and_grads(xyhat, (H, W))
    vert = torch.stack([cov - s[:, 0], dc_dx - s[:, 2], dc_dy - s[:, 3]], 1)

    # contour ICP over the vertices that project inside the image
    px, py = proj[..., 0], proj[..., 1]
    inside_f = ((px >= 0) & (px < imsize) & (py >= 0)
                & (py < imsize)).to(proj.dtype)
    _, idx, matched, in_match = contour_match_full_plain(contour, proj,
                                                         inside_f, inside_f)
    live = in_match > 0.5
    diff = matched - contour
    dist = torch.sqrt(torch.sum(diff ** 2, dim=-1) + 1e-12)
    mx = matched[..., 0].to(torch.int32).clamp(0, W - 1)
    my = matched[..., 1].to(torch.int32).clamp(0, H - 1)
    mxy = torch.stack([mx, my], dim=-1).to(proj.dtype) - origin[:, None, :]
    mask_at = bilinear_cov_grads_plain(crop, mxy, with_grads=False,
                                       with_cov=False)[:, 0]
    coeff = torch.where(mask_at < 0.1, epsilon, 1.0).to(proj.dtype)
    tp = torch.where(live, dist, 0.0) * coeff * cvalid
    wf = torch.where(live, coeff * cvalid / dist, 0.0)
    pix = torch.stack([tp, wf, diff[..., 0], diff[..., 1]], 1)
    sums = torch.stack([tree_sum(tp), vvalid * tree_sum(vert[:, 0])])
    return sums, idx, pix, vert


def mask_terms_backward_plain(idx, pix, vert, g_icp, g_binary, vvalid,
                              scale):
    """PyTorch version of :func:`mask_terms_backward` (any dtype/device)."""
    sx, sy = scale
    w = g_icp[:, None] * pix[:, 1]
    g = torch.stack([w * pix[:, 2], w * pix[:, 3]], dim=-1)
    d2 = rows_scatter_add_plain(idx, g, vert.shape[2])         # [BV, 2, M]
    gb = g_binary[:, None] * vvalid[:, None]
    return torch.stack([d2[:, 0] + (gb * vert[:, 1]) * sx,
                        d2[:, 1] + (gb * vert[:, 2]) * sy], dim=-1)


def _shapes(proj, contour, cvalid, crop, origin, vvalid):
    BV, M, _ = proj.shape
    P = contour.shape[1]
    if (proj.shape[2] != 2 or contour.shape != (BV, P, 2)
            or cvalid.shape != (BV, P) or crop.dim() != 3
            or crop.shape[0] != BV or origin.shape != (BV, 2)
            or vvalid.shape != (BV,)):
        raise ValueError(
            f"mask_terms: shapes proj {tuple(proj.shape)}, contour "
            f"{tuple(contour.shape)}, cvalid {tuple(cvalid.shape)}, crop "
            f"{tuple(crop.shape)}, origin {tuple(origin.shape)}, vvalid "
            f"{tuple(vvalid.shape)} do not agree")
    return BV, P, M


def mask_terms_forward(proj: torch.Tensor, contour: torch.Tensor,
                       cvalid: torch.Tensor, crop: torch.Tensor,
                       origin: torch.Tensor, vvalid: torch.Tensor,
                       imsize: float, epsilon: float, full_hw: tuple):
    """Both mask terms of every view, and what the backward needs.

    proj ``[BV, M, 2]`` projected vertices; contour ``[BV, P, 2]`` and
    its weights cvalid ``[BV, P]``; crop ``[BV, Hc, Wc]`` 0/1 content
    crops, f32 or a bit mask (int32 words of
    :func:`~bodyfitting_torch.ops.kernels.pack_bits`), at origin ``[BV,
    2]`` (x0, y0) in the full ``full_hw = (H, W)`` image; vvalid ``[BV]``
    zeroes a padded view's stay-inside term.  Returns ``(sums [2, BV]
    (icp, binary), idx [BV, P] int32, pix [BV, 4, P], vert [BV, 3, M])``
    as ``ops/csrc/mask_terms.cu`` states them.  Not differentiable:
    :func:`mask_terms_backward` is its backward.

    CPU tensors take the plain version; CUDA tensors (contiguous f32, the
    crop f32 or int32; ``half(P) + half(M) <=`` :data:`SUM_SHARED`, the
    next powers of two's halves, e.g. M up to 16,384 at P 512) launch the
    kernels, two launches for all views; anything else raises.
    """
    args = (proj, contour, cvalid, crop, origin, vvalid)
    if _build.on_cpu(*args):
        return mask_terms_forward_plain(*args, imsize, epsilon, full_hw)
    symbol = _SYMBOLS.get(crop.dtype)
    if symbol is None:
        raise ValueError(f"mask_terms_forward crop: expected float32 or int32 "
                         f"(a bit mask), got {crop.dtype}")
    f32 = torch.float32
    _build.require("mask_terms_forward proj", proj, f32, 3)
    _build.require("mask_terms_forward contour", contour, f32, 3)
    _build.require("mask_terms_forward cvalid", cvalid, f32, 2)
    _build.require("mask_terms_forward crop", crop, crop.dtype, 3)
    _build.require("mask_terms_forward origin", origin, f32, 2)
    _build.require("mask_terms_forward vvalid", vvalid, f32, 1)
    BV, P, M = _shapes(*args)
    _, Hc, Wc = crop.shape
    if crop.dtype == torch.int32:
        Wc *= 32
    H, W = full_hw
    if _half(P) + _half(M) > SUM_SHARED:
        raise ValueError(f"mask_terms_forward: P {P} and M {M} need "
                         f"{_half(P) + _half(M)} floats of shared memory "
                         f"for their sums, above {SUM_SHARED}")
    buf = torch.empty(BV * (2 + 4 * P + 3 * M), dtype=f32,
                      device=proj.device)
    sums = buf[:2 * BV].view(2, BV)
    pix = buf[2 * BV:2 * BV + BV * 4 * P].view(BV, 4, P)
    vert = buf[2 * BV + BV * 4 * P:].view(BV, 3, M)
    idx = torch.empty((BV, P), dtype=torch.int32, device=proj.device)
    sx, sy = (W - 1) / imsize, (H - 1) / imsize
    _build.launch(
        "mask_terms", symbol, proj.device,
        [proj.data_ptr(), contour.data_ptr(), cvalid.data_ptr(),
         crop.data_ptr(), origin.data_ptr(), vvalid.data_ptr(),
         sums.data_ptr(), pix.data_ptr(), vert.data_ptr(), idx.data_ptr()],
        [BV, P, M, Hc, Wc, H, W],
        [imsize, epsilon, sx, sy],
    )
    mask_terms_forward.launches += 2 if P + M else 1
    return sums, idx, pix, vert


mask_terms_forward.launches = 0


def mask_terms_backward(idx: torch.Tensor, pix: torch.Tensor,
                        vert: torch.Tensor, g_icp: torch.Tensor,
                        g_binary: torch.Tensor, vvalid: torch.Tensor,
                        scale: tuple) -> torch.Tensor:
    """``dproj [BV, M, 2]`` of :func:`mask_terms_forward` for the
    cotangents ``g_icp, g_binary [BV]``: the ICP rows ``(g_icp wf_p)
    (dx_p, dy_p)`` summed onto their matched vertices in ascending ``p``
    from 0 (as :func:`rows_scatter_add`), then ``((g_binary vvalid) (ex,
    ey)) * scale`` added per vertex.  ``scale``: the forward's
    ``((W - 1) / imsize, (H - 1) / imsize)`` as Python floats (they
    round to ``pix``'s dtype as :func:`pixel_scale` does).

    CPU tensors take the plain version; CUDA tensors (contiguous f32 and
    int32 idx) launch the kernel, one launch; anything else raises.
    """
    args = (idx, pix, vert, g_icp, g_binary, vvalid)
    if _build.on_cpu(*args):
        return mask_terms_backward_plain(*args, scale)
    f32 = torch.float32
    _build.require("mask_terms_backward idx", idx, torch.int32, 2)
    _build.require("mask_terms_backward pix", pix, f32, 3)
    _build.require("mask_terms_backward vert", vert, f32, 3)
    for what, t in (("g_icp", g_icp), ("g_binary", g_binary),
                    ("vvalid", vvalid)):
        _build.require(f"mask_terms_backward {what}", t, f32, 1)
    BV, P = idx.shape
    M = vert.shape[2]
    if (pix.shape != (BV, 4, P) or vert.shape != (BV, 3, M)
            or g_icp.shape != (BV,) or g_binary.shape != (BV,)
            or vvalid.shape != (BV,)):
        raise ValueError("mask_terms_backward: shapes do not agree with the "
                         "forward's")
    if M >= MAX_M:
        raise ValueError(f"mask_terms_backward: M {M} must be below {MAX_M} "
                         f"(the scatter packs idx into a 22-bit key)")
    dproj = torch.empty((BV, M, 2), dtype=f32, device=pix.device)
    _build.launch(
        "mask_terms", "mask_terms_backward_f32", pix.device,
        [idx.data_ptr(), pix.data_ptr(), vert.data_ptr(), g_icp.data_ptr(),
         g_binary.data_ptr(), vvalid.data_ptr(), dproj.data_ptr()],
        [BV, P, M], scale,
    )
    mask_terms_backward.launches += 1
    return dproj


mask_terms_backward.launches = 0


def forward_geometry(BV: int, P: int, M: int) -> dict:
    """The forward's launch geometry (builds the kernels if needed):
    launch 1's ``blocks``, ``threads`` and ``smem_bytes``, launch 2's
    ``sum_blocks`` and ``sum_threads``."""
    return _build.geometry("mask_terms", "mask_terms_forward_geometry",
                           [BV, P, M], FORWARD_GEOMETRY_KEYS)


def backward_geometry(BV: int, P: int, M: int) -> dict:
    """The backward's launch geometry: ``{"blocks", "threads",
    "smem_bytes"}``."""
    return _build.geometry("mask_terms", "mask_terms_backward_geometry",
                           [BV, P, M])
