"""Plain observations of a frame, worked out again from the raw inputs:
cameras as world-to-camera matrices, keypoints in the model's joint
order, and for mask views the silhouette's outer contour (the border of
its largest 8-connected component, holes filled, in OpenCV's
``findContours(RETR_EXTERNAL, CHAIN_APPROX_NONE)`` order), resampled to
equal arc length, and its content crop.

A frozen copy of the plain numpy preparation the GeneBody fit is
defined by (contour tracing after Suzuki and Abe 1985), kept here so the
benchmark holds the program's own preparation to it.
"""

from __future__ import annotations

import numpy as np

_DY = (0, -1, -1, -1, 0, 1, 1, 1)
_DX = (1, 1, 0, -1, -1, -1, 0, 1)


def _trace(img, y0, x0):
    s = 4
    while True:
        s = (s - 1) & 7
        if img[y0 + _DY[s], x0 + _DX[s]] or s == 4:
            break
    if s == 4:
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


def outer_contour(mask):
    """The longest outer contour of a 0/1 mask, ``[n, 2]`` (x, y); the
    last discovered of equals, as OpenCV lists them reversed."""
    from scipy import ndimage

    filled = ndimage.binary_fill_holes(mask > 0.5)
    labels, n = ndimage.label(filled, structure=np.ones((3, 3), bool))
    if n == 0:
        return np.zeros((0, 2), np.float32)
    flat = labels.ravel()
    nz = np.flatnonzero(flat)
    _, first = np.unique(flat[nz], return_index=True)
    padded = np.pad(filled, 1).astype(np.uint8)
    W = mask.shape[1]
    found = []
    for s in sorted(nz[first]):
        y, x = divmod(int(s), W)
        found.append(np.asarray(_trace(padded, y + 1, x + 1), np.float32) - 1)
    found = found[::-1]
    return found[int(np.argmax([len(c) for c in found]))]


def resample(pts, n_out):
    """``(points [n_out, 2], weights [n_out])``: a contour longer than
    ``n_out`` at equal arc length, each point weighted ``n / n_out``;
    a shorter one as it is, weight 1, zero-padded."""
    out = np.zeros((n_out, 2), np.float32)
    w = np.zeros((n_out,), np.float32)
    n = len(pts)
    if n <= n_out:
        out[:n], w[:n] = pts, 1.0
        return out, w
    closed = np.concatenate([pts, pts[:1]])
    seg = np.linalg.norm(np.diff(closed, axis=0), axis=1)
    arc = np.concatenate([[0.0], np.cumsum(seg)])
    t_arc = np.linspace(0.0, arc[-1], n_out, endpoint=False)
    i = np.clip(np.searchsorted(arc, t_arc, side="right") - 1, 0, n - 1)
    t = (t_arc - arc[i]) / np.maximum(seg[i], 1e-9)
    out[:] = closed[i] * (1.0 - t[:, None]) + closed[i + 1] * t[:, None]
    w[:] = n / float(n_out)
    return out, w


def crop(mask, hw, margin=2):
    """``(crop [Hc, Wc], origin (x0, y0))``: the window of size ``hw``
    that holds every set pixel with ``margin`` to spare, at the content's
    top-left less the margin, kept inside the image."""
    H, W = mask.shape
    Hc, Wc = hw
    ys, xs = np.nonzero(mask > 0.5)
    y0, x0 = (int(ys.min()), int(xs.min())) if ys.size else (0, 0)
    oy = min(max(y0 - margin, 0), H - Hc)
    ox = min(max(x0 - margin, 0), W - Wc)
    return ((mask[oy:oy + Hc, ox:ox + Wc] > 0.5).astype(np.float32),
            np.array([ox, oy], np.float32))


def mask_views(masks, contour_points, crop_hw):
    """Each mask view's contour, weights, crop and crop origin, stacked."""
    cs, ws, crops, origins = [], [], [], []
    for m in masks:
        c, w = resample(outer_contour(m), contour_points)
        k, o = crop(m, crop_hw)
        cs.append(c), ws.append(w), crops.append(k), origins.append(o)
    return (np.stack(cs), np.stack(ws), np.stack(crops), np.stack(origins))
