"""Host-side image preparation: decode, mask-driven square crops, resizes.

Counterpart of ``bodyfitting_tpu/io/images.py`` without OpenCV.  The
square bbox and the intrinsics adjustment are the same decisions;
``crop_and_resize`` reproduces ``cv2.resize(..., INTER_LINEAR)``'s
arithmetic on uint8 (11-bit fixed-point weights, OpenCV's rounding), and
:func:`resize_cubic` ``INTER_CUBIC``'s within one level (see each).
Images decode through ``io/png.py`` and ``io/jpeg.py``.
"""

from __future__ import annotations

import os

import numpy as np

from bodyfitting_torch.io.jpeg import (
    SIGNATURE as JPEG_SIGNATURE,
    apply_orientation,
    decode_jpeg,
    exif_orientation,
)
from bodyfitting_torch.io.png import decode_png

IMREAD_UNCHANGED = -1      # cv2's flag values, for the same call sites
IMREAD_COLOR = 1


def imread_checked(path: str, flags=None) -> np.ndarray:
    """Read an image as ``cv2.imread`` would, raising
    ``FileNotFoundError`` naming the file when it is missing or
    unreadable.

    ``IMREAD_COLOR`` (the default) gives ``[H, W, 3]`` in BGR order;
    ``IMREAD_UNCHANGED`` gives grey as ``[H, W]``, grey + alpha as BGRA,
    RGB as BGR and RGBA as BGRA, as OpenCV does.  PNG or JPEG; a JPEG's
    EXIF orientation is applied under ``IMREAD_COLOR`` and not under
    ``IMREAD_UNCHANGED``, as OpenCV does.  An image the decoders refuse
    raises ``FileNotFoundError`` too (where ``cv2.imread`` returns
    ``None``)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise FileNotFoundError(f"cannot read image: {path}") from e
    jpeg = data[:3] == JPEG_SIGNATURE
    try:
        img = decode_jpeg(data, path) if jpeg else decode_png(data, path)
    except ValueError as e:
        raise FileNotFoundError(f"cannot read image: {path} ({e})") from e
    if jpeg and flags != IMREAD_UNCHANGED:
        img = apply_orientation(img, exif_orientation(data))
    if img.ndim == 3 and img.shape[2] == 2:          # grey + alpha -> BGRA
        img = np.concatenate([img[..., :1].repeat(3, 2), img[..., 1:]], 2)
    if img.ndim == 3:
        img = np.concatenate([img[..., 2::-1], img[..., 3:]], 2)  # RGB -> BGR
    if flags is None or flags == IMREAD_COLOR:
        if img.ndim == 2:
            img = img[..., None].repeat(3, 2)
        img = img[..., :3]
    return np.ascontiguousarray(img)


def imwrite(path: str, img: np.ndarray) -> None:
    """Write ``img`` (uint8, RGB or grey) as a PNG, as the JAX app's
    ``imageio.imwrite`` does."""
    from bodyfitting_torch.io.png import write_png

    if os.path.splitext(path)[1].lower() != ".png":
        raise ValueError(f"{path}: the port writes PNG files only")
    write_png(path, np.asarray(img, np.uint8))


def mask_square_bbox(mask: np.ndarray) -> tuple[int, int, int, int]:
    """``(top, left, bottom, right)`` square crop window from a mask: the
    tight bbox padded by 10 % of its size (the left pad uses the height,
    the reference's quirk), grown to a square that slides to stay inside
    the image."""
    ys, xs = np.nonzero(mask)
    h, w = mask.shape[:2]
    top, left = int(ys.min()), int(xs.min())
    bottom, right = int(ys.max()), int(xs.max())
    bbox_h, bbox_w = bottom - top, right - left

    bottom = min(int(bbox_h * 0.1 + bottom), h)
    top = max(int(top - bbox_h * 0.1), 0)
    right = min(int(bbox_w * 0.1 + right), w)
    left = max(int(left - bbox_h * 0.1), 0)   # quirk: uses bbox_h
    bbox_h, bbox_w = bottom - top, right - left

    if bbox_h >= bbox_w:
        center = (left + right) / 2
        size = bbox_h
        if center - size / 2 < 0:
            left, right = 0, size
        elif center + size / 2 >= w:
            left, right = w - size, w
        else:
            left = int(center - size / 2)
            right = left + size
    else:
        center = (top + bottom) / 2
        size = bbox_w
        if center - size / 2 < 0:
            top, bottom = 0, size
        elif center + size / 2 >= h:
            top, bottom = h - size, h
        else:
            top = int(center - size / 2)
            bottom = top + size
    return top, left, bottom, right


# OpenCV's fixed-point resize: weights scaled by 2^11, rounded to int16
_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


def _linear_taps(src: int, dst: int, clamp_weights: bool):
    """OpenCV's INTER_LINEAR source indices and weight fractions along one
    axis: ``(i0, i1, f)`` per output position, the sample being
    ``(1 - f) src[i0] + f src[i1]``.  Along x OpenCV moves an outside
    position's weight onto the edge pixel (``clamp_weights``); along y
    it keeps the weights and clamps the row indices only."""
    scale = 1.0 / (dst / src)
    d = np.arange(dst, dtype=np.float64)
    f = ((d + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp_weights:
        low = s < 0
        f[low], s[low] = 0.0, 0
        high = s >= src - 1
        f[high], s[high] = 0.0, src - 1
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), f


def _fixed(f: np.ndarray):
    """The int16 fixed-point weights ``(1 - f, f) * 2^11``, rounded."""
    one = np.float32(_COEF_SCALE)
    return (np.rint((np.float32(1.0) - f) * one).astype(np.int64),
            np.rint(f * one).astype(np.int64))


def resize_linear(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """``cv2.resize(img, (out_w, out_h), interpolation=INTER_LINEAR)``.

    uint8 follows OpenCV's fixed-point arithmetic: an exact integer
    horizontal pass with 11-bit weights, then its SIMD vertical pass
    (``VResizeLinearVec_32s8u``: each row shifted right by 4, the high
    half of its 16-bit product with the weight, the two summed and
    rounded as ``(x + 2) >> 2``).  An exact halving is OpenCV's
    INTER_AREA fast path.  uint8 only (the app's images and masks)."""
    if img.dtype != np.uint8:
        raise ValueError(f"resize_linear: expected uint8, got {img.dtype}")
    h, w = img.shape[:2]
    if w == out_w and h == out_h:
        return img.copy()                  # OpenCV copies
    if w == 2 * out_w and h == 2 * out_h:
        s = img.astype(np.int64)
        q = s[0::2, 0::2] + s[0::2, 1::2] + s[1::2, 0::2] + s[1::2, 1::2]
        return ((q + 2) >> 2).astype(np.uint8)
    x0, x1, fx = _linear_taps(w, out_w, True)
    y0, y1, fy = _linear_taps(h, out_h, False)
    hshape = (1, -1) + (1,) * (img.ndim - 2)
    vshape = (-1, 1) + (1,) * (img.ndim - 2)
    a0, a1 = _fixed(fx)
    b0, b1 = _fixed(fy)
    src = img.astype(np.int64)
    hz = src[:, x0] * a0.reshape(hshape) + src[:, x1] * a1.reshape(hshape)
    s0 = ((hz[y0] >> 4) * b0.reshape(vshape)) >> 16
    s1 = ((hz[y1] >> 4) * b1.reshape(vshape)) >> 16
    return np.clip((s0 + s1 + 2) >> 2, 0, 255).astype(np.uint8)


def crop_and_resize(img: np.ndarray, bbox: tuple[int, int, int, int],
                    out_size: int) -> np.ndarray:
    """Crop to the bbox and resize to ``out_size`` square with
    INTER_LINEAR, what the reference actually runs (its INTER_NEAREST is
    passed positionally and ignored by cv2)."""
    top, left, bottom, right = bbox
    return resize_linear(np.ascontiguousarray(img[top:bottom, left:right]),
                         out_size, out_size)


def _cubic_weights(f: np.ndarray) -> np.ndarray:
    """OpenCV's cubic convolution weights (A = -0.75) for fractions ``f``."""
    A = -0.75
    c0 = ((A * (f + 1) - 5 * A) * (f + 1) + 8 * A) * (f + 1) - 4 * A
    c1 = ((A + 2) * f - (A + 3)) * f * f + 1
    c2 = ((A + 2) * (1 - f) - (A + 3)) * (1 - f) * (1 - f) + 1
    return np.stack([c0, c1, c2, 1.0 - c0 - c1 - c2], -1)


def resize_cubic(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """``cv2.resize(img, (out_w, out_h), interpolation=INTER_CUBIC)`` on
    uint8, within one level: OpenCV's taps, replicated borders and
    fixed-point weights, summed exactly and rounded once."""
    h, w = img.shape[:2]

    def taps(src, dst):
        scale = 1.0 / (dst / src)
        f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
        s = np.floor(f).astype(np.int64)
        wts = _cubic_weights((f - s).astype(np.float32))
        wts = np.rint(wts.astype(np.float32) * np.float32(_COEF_SCALE))
        idx = np.clip(s[:, None] + np.arange(-1, 3), 0, src - 1)
        return idx, wts.astype(np.int64)

    xi, xw = taps(w, out_w)
    yi, yw = taps(h, out_h)
    src = img.astype(np.int64)
    extra = (1,) * (img.ndim - 2)
    hz = sum(src[:, xi[:, k]] * xw[:, k].reshape((1, -1) + extra)
             for k in range(4))
    vt = sum(hz[yi[:, k]] * yw[:, k].reshape((-1, 1) + extra)
             for k in range(4))
    return np.clip(np.rint(vt / float(1 << (2 * _COEF_BITS))), 0,
                   255).astype(np.uint8)


def adjust_K_for_crop(K: np.ndarray, bbox: tuple[int, int, int, int],
                      out_size: int) -> np.ndarray:
    """Intrinsics after crop + resize."""
    top, left, bottom, right = bbox
    K = np.array(K, np.float64, copy=True)
    K[0, 2] -= left
    K[1, 2] -= top
    K[0, :] *= out_size / float(right - left)
    K[1, :] *= out_size / float(bottom - top)
    return K.astype(np.float32)


def apply_mask(img: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Zero the background (``img * (mask > 128)[..., None]``)."""
    return img * (mask > 128)[..., None]


def bbox_from_keypoints(keypoints, rescale: float = 1.2,
                        detection_thresh: float = 0.2):
    """``(center, SPIN scale)`` from confident 2D keypoints."""
    kp = np.reshape(np.asarray(keypoints, np.float64), (-1, 3))
    valid = kp[:, -1] > detection_thresh
    pts = kp[valid][:, :2]
    center = pts.mean(axis=0)
    size = (pts.max(axis=0) - pts.min(axis=0)).max()
    return center, size / 200.0 * rescale
