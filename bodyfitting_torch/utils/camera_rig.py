"""Calibrated RGB-D camera rigs with Brown-Conrady distortion.

Counterpart of ``bodyfitting_tpu/utils/camera_rig.py`` (host numpy): a
distortion-aware pinhole camera (resize, 90-degree rotations,
distort/undistort, depth reprojection) and the dual-camera (ToF + RGB)
mapping.  Calibration is rig-specific data that callers load from their
own configs (:meth:`DistortionCamera.from_flat`).  The rig's rotation
vector becomes a matrix by ``ops.rotations.rodrigues_np``, the
computation OpenCV's ``Rodrigues`` does in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def undistort_points(points: np.ndarray, dist: np.ndarray) -> np.ndarray:
    """One-step inverse Brown-Conrady on focalised points ``[K, 2]``
    (a single-iteration approximation)."""
    k1, k2, p1, p2, k3 = dist
    xx, yy = points[:, 0] ** 2, points[:, 1] ** 2
    rr = xx + yy
    xy2 = 2 * points[:, 0] * points[:, 1]
    t = 1.0 / (1 + ((k3 * rr + k2) * rr + k1) * rr)
    dx = p1 * xy2 + p2 * (rr + 2 * xx)
    dy = p1 * (rr + 2 * yy) + p2 * xy2
    return np.stack(
        [(points[:, 0] - dx) * t, (points[:, 1] - dy) * t], axis=1
    )


def distort_points(points: np.ndarray, dist: np.ndarray) -> np.ndarray:
    """Forward Brown-Conrady on focalised points."""
    k1, k2, p1, p2, k3 = dist
    x, y = points[:, 0], points[:, 1]
    r2 = x * x + y * y
    radial = 1 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([xd, yd], axis=1)


@dataclasses.dataclass
class DistortionCamera:
    """Pinhole + Brown-Conrady distortion."""

    K: np.ndarray              # [3, 3]
    dist: np.ndarray           # [5] (k1, k2, p1, p2, k3)
    width: float
    height: float

    @staticmethod
    def from_flat(args) -> "DistortionCamera":
        """``[fx, fy, cx, cy, k1, k2, p1, p2, k3, w, h]``"""
        K = np.array(
            [[args[0], 0, args[2]], [0, args[1], args[3]], [0, 0, 1]],
            np.float64,
        )
        return DistortionCamera(
            K=K, dist=np.asarray(args[4:9], np.float64),
            width=args[9], height=args[10],
        )

    @property
    def fx(self):
        return self.K[0, 0]

    @property
    def fy(self):
        return self.K[1, 1]

    @property
    def cx(self):
        return self.K[0, 2]

    @property
    def cy(self):
        return self.K[1, 2]

    def resize(self, scale: float) -> "DistortionCamera":
        K = self.K * scale
        K[2, 2] = 1.0
        return dataclasses.replace(
            self, K=K, width=self.width * scale, height=self.height * scale
        )

    def rotate(self, orient: int) -> "DistortionCamera":
        """Rotate intrinsics clockwise by orient x 90 degrees"""
        K = self.K.copy()
        dist = self.dist.copy()
        w, h = self.width, self.height
        if orient == 0:
            return self
        if orient == 1:
            K[0, 0], K[1, 1] = self.fy, self.fx
            K[0, 2], K[1, 2] = h - self.cy, self.cx
            dist[[2, 3]] = dist[[3, 2]]
            w, h = h, w
        elif orient == 2:
            K[0, 2], K[1, 2] = w - self.cx, h - self.cy
        elif orient == 3:
            K[0, 0], K[1, 1] = self.fy, self.fx
            K[0, 2], K[1, 2] = self.cy, w - self.cx
            dist[[2, 3]] = dist[[3, 2]]
            w, h = h, w
        return dataclasses.replace(self, K=K, dist=dist, width=w, height=h)

    def undistort(self, points: np.ndarray) -> np.ndarray:
        return undistort_points(points, self.dist)

    def distort(self, points: np.ndarray) -> np.ndarray:
        return distort_points(points, self.dist)

    def reproject(self, points: np.ndarray, depth: np.ndarray) -> np.ndarray:
        """Pixels + z-depth -> camera-space 3D."""
        f = np.array([self.fx, self.fy])
        c = np.array([self.cx, self.cy])
        p = self.undistort((points - c) / f)
        depth = np.asarray(depth, np.float64).reshape(-1, 1)
        return np.concatenate([p * depth, depth], axis=1)

    def project(self, points3d: np.ndarray) -> np.ndarray:
        """Camera-space 3D -> distorted pixel coords."""
        f = np.array([self.fx, self.fy])
        c = np.array([self.cx, self.cy])
        p = points3d[:, :2] / points3d[:, 2:3]
        return self.distort(p) * f + c


@dataclasses.dataclass
class DualCamera:
    """ToF + RGB rig; maps ToF pixel+depth samples into the RGB image."""

    rgb: DistortionCamera
    tof: DistortionCamera
    rvec: np.ndarray           # rgb->tof rotation (Rodrigues)
    tvec: np.ndarray           # rgb->tof translation

    def _rotation(self) -> np.ndarray:
        from bodyfitting_torch.ops.rotations import rodrigues_np

        return rodrigues_np(self.rvec)

    def tof2rgb(self, points: np.ndarray) -> np.ndarray:
        """``[K, 3]`` (u, v, depth) in the ToF frame -> RGB pixels
        ``[K, 2]``."""
        f = np.array([self.tof.fx, self.tof.fy])
        c = np.array([self.tof.cx, self.tof.cy])
        uv = undistort_points((points[:, :2] - c) / f, self.tof.dist)
        s3d = np.concatenate(
            [uv, np.ones((len(uv), 1))], axis=1
        ) * points[:, 2:3]
        s3d_rgb = (s3d + np.asarray(self.tvec)) @ self._rotation()
        uv_rgb = s3d_rgb[:, :2] / s3d_rgb[:, 2:3]
        uv_rgb = distort_points(uv_rgb, self.rgb.dist)
        return uv_rgb * np.array([self.rgb.fx, self.rgb.fy]) + np.array(
            [self.rgb.cx, self.rgb.cy]
        )


def reproject3d(s2d: np.ndarray, depth: np.ndarray, K: np.ndarray,
                dist: np.ndarray = None) -> np.ndarray:
    """2D keypoints + depth -> camera-space 3D."""
    f = np.array([K[0, 0], K[1, 1]])
    c = np.array([K[0, 2], K[1, 2]])
    p = (np.asarray(s2d, np.float64) - c) / f
    if dist is not None:
        p = undistort_points(p, dist)
    depth = np.asarray(depth, np.float64).reshape(-1, 1)
    return np.concatenate([p * depth, depth], axis=1)
