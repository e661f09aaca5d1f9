"""SPIN-style image and keypoint helpers (host numpy).

Counterpart of ``bodyfitting_tpu/utils/imutils.py``: the centre + scale
crop transform of HMR's preprocessing (a box of ``200 * scale`` pixels),
its inverse, and the left-right flips of images, SPIN keypoints and SMPL
pose vectors.  The contract is inherited exactly: HMR was trained on
crops made by SPIN's MIT-licensed ``utils/imutils.py``, with its 1-based
pixel offsets and integer truncations, so the formulas are SPIN's.

The JAX package resamples with OpenCV, which the card's machine lacks;
the port does it in numpy: ``io.images.resize_linear_f32`` and
``resize_nearest`` (OpenCV's results), and :func:`warp_affine_linear`
(a model of OpenCV 5's ``warpAffine``) for rotated crops.
"""

from __future__ import annotations

import numpy as np

from bodyfitting_torch.io.images import resize_linear_f32, resize_nearest

# SMPL pose-parameter permutation under a left-right flip (SPIN convention).
SMPL_POSE_FLIP_PERM = []
for i in [0, 2, 1, 3, 5, 4, 6, 8, 7, 9, 11, 10, 12, 14, 13, 15, 17, 16, 19,
          18, 21, 20, 23, 22]:
    SMPL_POSE_FLIP_PERM.extend([3 * i, 3 * i + 1, 3 * i + 2])

# SPIN left-right swaps: the 24 GT joints alone (J24) and OpenPose 25 +
# the 24 GT joints (J49).
J24_FLIP_PERM = [5, 4, 3, 2, 1, 0, 11, 10, 9, 8, 7, 6, 12, 13, 14, 15, 16,
                 17, 18, 19, 21, 20, 23, 22]
SPIN_JOINT_FLIP_PERM = (
    [0, 1, 5, 6, 7, 2, 3, 4, 8, 12, 13, 14, 9, 10, 11, 16, 15, 18, 17,
     22, 23, 24, 19, 20, 21]
    + [25 + i for i in J24_FLIP_PERM]
)


def get_transform(center, scale, res, rot=0):
    """Affine (3x3) mapping original-image pixels into the crop's pixels:
    the square of side ``200 * scale`` centred on ``center``, resampled
    to ``res = (out_h, out_w)``, turned by ``rot`` degrees about the
    crop's centre."""
    box_h = 200.0 * scale
    out_h, out_w = float(res[0]), float(res[1])
    m = np.array([
        [out_w / box_h, 0.0, out_w * (-float(center[0]) / box_h + 0.5)],
        [0.0, out_h / box_h, out_h * (-float(center[1]) / box_h + 0.5)],
        [0.0, 0.0, 1.0],
    ])
    if rot != 0:
        ang = -rot * np.pi / 180.0
        cs, sn = np.cos(ang), np.sin(ang)
        spin = np.array([[cs, -sn, 0.0], [sn, cs, 0.0], [0.0, 0.0, 1.0]])
        to_center = np.eye(3)
        to_center[:2, 2] = [-out_w / 2, -out_h / 2]
        from_center = np.eye(3)
        from_center[:2, 2] = [out_w / 2, out_h / 2]
        m = from_center @ spin @ to_center @ m
    return m


def transform(pt, center, scale, res, invert=0, rot=0):
    """One pixel mapped between the original and the cropped frame, with
    SPIN's quirks: 1-based on the way in and out, truncated to int (the
    integer crop boxes depend on it)."""
    m = get_transform(center, scale, res, rot=rot)
    if invert:
        m = np.linalg.inv(m)
    mapped = m @ np.array([pt[0] - 1, pt[1] - 1, 1.0])
    return mapped[:2].astype(int) + 1


def _overlap(box_ul, box_br, img_h, img_w):
    """Index ranges pasting the image region ``[ul, br)`` into a canvas
    whose origin sits at ``box_ul``: ``(canvas_y, canvas_x, image_y,
    image_x)`` as (start, stop) pairs."""
    canvas_x = max(0, -box_ul[0]), min(box_br[0], img_w) - box_ul[0]
    canvas_y = max(0, -box_ul[1]), min(box_br[1], img_h) - box_ul[1]
    image_x = max(0, box_ul[0]), min(img_w, box_br[0])
    image_y = max(0, box_ul[1]), min(img_h, box_br[1])
    return canvas_y, canvas_x, image_y, image_x


def _crop_box(center, scale, res):
    """Integer (x, y) corners of the crop box in original-image pixels."""
    box_ul = np.array(transform([1, 1], center, scale, res, invert=1)) - 1
    box_br = np.array(
        transform([res[0] + 1, res[1] + 1], center, scale, res, invert=1)
    ) - 1
    return box_ul, box_br


def rotation_matrix_2d(center, angle: float, scale: float = 1.0):
    """``cv2.getRotationMatrix2D``: the 2x3 matrix turning by ``angle``
    degrees (counter-clockwise in the image) about ``center``."""
    a = np.deg2rad(angle)
    alpha, beta = np.cos(a) * scale, np.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _fma32(a, b, c):
    """``fma(a, b, c)`` in float32 (the product exact in float64, the sum
    rounded there and then to float32)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


# The columns OpenCV 5.0's warpAffine computes a block at a time (its
# AVX2 loop); the tail of a row goes through its scalar code.
_SIMD_COLUMNS = 16


def warp_affine_linear(img: np.ndarray, M: np.ndarray, size) -> np.ndarray:
    """``cv2.warpAffine(img, M, size)`` of a float32 image (bilinear, a
    constant-0 border) by OpenCV 5's model: the inverse map in float32;
    each pixel's source position ``fma(m0, x, m1 y + m2)`` where its SIMD
    loop runs (whole blocks of ``_SIMD_COLUMNS`` columns) and ``fma(m0,
    x, m1 y) + m2`` in the scalar tail; the taps at ``floor`` of the
    position (outside the image: 0) blended by ``fma(b - a, t, a)`` along
    x, then y.  The model is fitted to OpenCV 5.0's results on this
    package's tests (``tests/test_torch_imutils.py`` measures what still
    differs)."""
    img = np.asarray(img, np.float32)
    W, H = size
    M = np.asarray(M, np.float64)
    D = M[0, 0] * M[1, 1] - M[0, 1] * M[1, 0]
    D = 1.0 / D if D != 0 else 0.0
    inv = np.array([[M[1, 1] * D, -M[0, 1] * D, 0.0],
                    [-M[1, 0] * D, M[0, 0] * D, 0.0]])
    inv[0, 2] = -inv[0, 0] * M[0, 2] - inv[0, 1] * M[1, 2]
    inv[1, 2] = -inv[1, 0] * M[0, 2] - inv[1, 1] * M[1, 2]
    inv = inv.astype(np.float32)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    simd = xs < W - W % _SIMD_COLUMNS

    def coord(k):
        a, b, c = inv[k]
        vec = _fma32(a, xs, (b * ys + c).astype(np.float32))
        tail = (_fma32(a, xs, b * ys) + c).astype(np.float32)
        return np.where(simd, vec, tail)

    X, Y = coord(0), coord(1)
    x0, y0 = np.floor(X), np.floor(Y)
    fx, fy = (X - x0).astype(np.float32), (Y - y0).astype(np.float32)
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    h, w = img.shape[:2]
    extra = (1,) * (img.ndim - 2)

    def tap(yy, xx):
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        t = img[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
        return np.where(inside.reshape(inside.shape + extra), t,
                        np.float32(0))

    def lerp(a, b, t):
        return _fma32((b - a).astype(np.float32), t.reshape(t.shape + extra),
                      a)

    top = lerp(tap(y0, x0), tap(y0, x0 + 1), fx)
    bottom = lerp(tap(y0 + 1, x0), tap(y0 + 1, x0 + 1), fx)
    return lerp(top, bottom, fy)


def crop(img, center, scale, res, rot=0):
    """Crop and resize with zero padding; with a rotation the canvas is
    grown by a diagonal-sized margin first, so the turned content never
    clips, then trimmed back."""
    box_ul, box_br = _crop_box(center, scale, res)
    margin = int(np.linalg.norm(box_br - box_ul) / 2
                 - float(box_br[1] - box_ul[1]) / 2)
    if rot != 0:
        box_ul -= margin
        box_br += margin
    canvas_shape = [box_br[1] - box_ul[1], box_br[0] - box_ul[0]]
    if img.ndim > 2:
        canvas_shape += [img.shape[2]]
    canvas = np.zeros(canvas_shape, dtype=img.dtype)
    cy, cx, iy, ix = _overlap(box_ul, box_br, img.shape[0], img.shape[1])
    canvas[cy[0]:cy[1], cx[0]:cx[1]] = img[iy[0]:iy[1], ix[0]:ix[1]]
    if rot != 0:
        spin = rotation_matrix_2d(
            (canvas.shape[1] / 2, canvas.shape[0] / 2), rot, 1.0)
        canvas = warp_affine_linear(canvas.astype(np.float32), spin,
                                    (canvas.shape[1], canvas.shape[0]))
        canvas = canvas[margin:-margin, margin:-margin]
    return resize_linear_f32(canvas.astype(np.float32), res[1],
                             res[0]).astype(img.dtype)


def uncrop(img, center, scale, orig_shape):
    """Paste a cropped image back into the original frame
    (nearest-neighbour upsampling)."""
    res = img.shape[:2]
    box_ul, box_br = _crop_box(center, scale, res)
    restored = np.zeros(orig_shape, dtype=img.dtype)
    cy, cx, iy, ix = _overlap(box_ul, box_br, orig_shape[0], orig_shape[1])
    img = resize_nearest(img.astype(np.float32), box_br[0] - box_ul[0],
                         box_br[1] - box_ul[1]).astype(restored.dtype)
    restored[iy[0]:iy[1], ix[0]:ix[1]] = img[cy[0]:cy[1], cx[0]:cx[1]]
    return restored


def rot_aa(aa, rot):
    """Rotate an axis-angle vector about the z axis by ``rot`` degrees."""
    from bodyfitting_torch.ops.rotations import (
        rodrigues_np,
        rotmat_to_aa_f64_np,
    )

    ang = np.deg2rad(-rot)
    Rz = np.array([[np.cos(ang), -np.sin(ang), 0],
                   [np.sin(ang), np.cos(ang), 0],
                   [0, 0, 1]])
    rotated = rotmat_to_aa_f64_np(Rz @ rodrigues_np(aa))
    return rotated.astype(aa.dtype if hasattr(aa, "dtype") else np.float32)


def flip_img(img):
    """Horizontal image flip."""
    return np.fliplr(img)


def flip_kp(kp):
    """Flip SPIN keypoints left <-> right: the 24 GT joints, or the
    49-joint superset, by their length."""
    perm = J24_FLIP_PERM if len(kp) == 24 else SPIN_JOINT_FLIP_PERM
    kp = kp[perm].copy()
    kp[:, 0] = -kp[:, 0]
    return kp


def flip_pose(pose):
    """Flip SMPL pose parameters (72) left <-> right."""
    pose = np.asarray(pose)[SMPL_POSE_FLIP_PERM].copy()
    pose[1::3] = -pose[1::3]
    pose[2::3] = -pose[2::3]
    return pose
