"""Depth-map helpers: colourised depth for debug images, depth map ->
point cloud, and the cloud as OBJ vertices.

Counterpart of ``bodyfitting_tpu/utils/reconstruction.py`` (host numpy).
The JAX package colours depth with ``cv2.applyColorMap(...,
COLORMAP_JET)``; :data:`JET_LUT_BGR` is that table, built the way
OpenCV builds it.
"""

from __future__ import annotations

import numpy as np


def _jet_lut_bgr() -> np.ndarray:
    """OpenCV's ``COLORMAP_JET`` as a ``[256, 3]`` uint8 BGR table: GNU
    Octave's ``jet`` at 256 points (rounded to float32), resampled by
    OpenCV's float32 ``interp1`` onto its float32 ``linspace`` (each entry
    interpolated from the one before it), then scaled by 255 and rounded
    half to even."""
    x = np.linspace(0.0, 1.0, 256)
    r = (((x >= 3 / 8) & (x < 5 / 8)) * (4 * x - 3 / 2)
         + ((x >= 5 / 8) & (x < 7 / 8)) + (x >= 7 / 8) * (-4 * x + 9 / 2))
    g = (((x >= 1 / 8) & (x < 3 / 8)) * (4 * x - 1 / 2)
         + ((x >= 3 / 8) & (x < 5 / 8))
         + ((x >= 5 / 8) & (x < 7 / 8)) * (-4 * x + 7 / 2))
    b = ((x < 1 / 8) * (4 * x + 1 / 2) + ((x >= 1 / 8) & (x < 3 / 8))
         + ((x >= 3 / 8) & (x < 5 / 8)) * (-4 * x + 5 / 2))
    Y = np.stack([b, g, r], -1).astype(np.float32)
    step = np.float32(1.0) / np.float32(255.0)
    X = np.arange(256, dtype=np.float32) * step
    lo = np.maximum(np.arange(256) - 1, 0)
    hi = np.maximum(np.arange(256), 1)
    out = Y[lo] + ((X - X[lo])[:, None] * (Y[hi] - Y[lo])
                   / (X[hi] - X[lo])[:, None])
    return np.rint(out * np.float32(255.0)).astype(np.uint8)


JET_LUT_BGR = _jet_lut_bgr()


def copy2cpu(x) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def depth_colorize(depth: np.ndarray, max_depth: float = None) -> np.ndarray:
    """Depth -> uint8 BGR jet colours ``[H, W, 3]``: the valid (positive)
    depths scaled from their minimum to ``max_depth`` (default: their
    maximum), clamped before the uint8 cast; invalid pixels black."""
    d = np.asarray(depth, np.float32)
    valid = d > 0
    if not valid.any():
        return np.zeros(d.shape + (3,), np.uint8)
    dmax = max_depth or float(d[valid].max())
    dmin = float(d[valid].min())
    norm = np.zeros_like(d)
    norm[valid] = (d[valid] - dmin) / max(dmax - dmin, 1e-6)
    img = JET_LUT_BGR[np.clip(norm * 255, 0, 255).astype(np.uint8)]
    img[~valid] = 0
    return img


def pointcloud_from_depthmap(depth: np.ndarray, K: np.ndarray,
                             c2w: np.ndarray = None,
                             color: np.ndarray = None, stride: int = 1,
                             depth_scale: float = 1.0,
                             max_depth: float = np.inf):
    """Unproject a depth map (every ``stride``-th pixel, times
    ``depth_scale``, valid where ``0 < d < max_depth``) to camera space,
    or to the world with ``c2w``.  Returns ``(points [N, 3], colors [N,
    3] or None)``."""
    d = np.asarray(depth, np.float64)[::stride, ::stride] * depth_scale
    H, W = d.shape
    ys, xs = np.mgrid[0:H, 0:W]
    xs = xs * stride
    ys = ys * stride
    valid = (d > 0) & (d < max_depth)
    z = d[valid]
    x = (xs[valid] - K[0, 2]) / K[0, 0] * z
    y = (ys[valid] - K[1, 2]) / K[1, 1] * z
    pts = np.stack([x, y, z], axis=1)
    if c2w is not None:
        R, t = np.asarray(c2w)[:3, :3], np.asarray(c2w)[:3, 3]
        pts = pts @ R.T + t
    cols = None
    if color is not None:
        cols = np.asarray(color)[::stride, ::stride][valid]
    return pts, cols


def save_pointcloud_obj(path: str, points: np.ndarray,
                        colors: np.ndarray = None) -> None:
    """A point cloud as OBJ vertices, with rgb in [0, 1] when given
    (colours above 1 are read as 0-255)."""
    with open(path, "w") as f:
        if colors is None:
            for p in points:
                f.write("v %.6f %.6f %.6f\n" % (p[0], p[1], p[2]))
            return
        c = np.asarray(colors, np.float64)
        if c.max() > 1.0:
            c = c / 255.0
        for p, col in zip(points, c):
            f.write("v %.6f %.6f %.6f %.4f %.4f %.4f\n"
                    % (p[0], p[1], p[2], col[0], col[1], col[2]))
