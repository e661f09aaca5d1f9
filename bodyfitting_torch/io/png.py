"""PNG reading and writing without OpenCV, imageio or PIL.

The port's stand-in for ``cv2.imread`` / ``imageio.imwrite`` on PNG
files (the machine with the card has none of those libraries).  Reads
8-bit grey, grey + alpha, RGB and RGBA images, non-interlaced, with all
five row filters; the rows are unfiltered by a small host C++ function
(``ops/csrc/png_unfilter.cpp``, built at first use), since the Average
and Paeth filters are sequential along a row.  Writes with filter 0
(None).  Anything else (16-bit samples, palettes, interlacing) raises
``ValueError`` naming the file.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}   # colour type -> samples per pixel


def _unfilter(raw: bytes, height: int, stride: int, bpp: int,
              path: str) -> np.ndarray:
    from bodyfitting_torch.ops.kernels import _build

    fn = _build.library("png_unfilter").png_unfilter
    fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int]
    fn.restype = ctypes.c_int
    out = np.empty((height, stride), np.uint8)
    bad = fn(raw, out.ctypes.data, height, stride, bpp)
    if bad:
        raise ValueError(f"{path}: row {bad - 1} has an unknown PNG filter "
                         f"type")
    return out


def decode_png(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """The image in PNG ``data`` as uint8 ``[H, W]`` (grey) or
    ``[H, W, C]`` (C = 2 grey + alpha, 3 RGB, 4 RGBA)."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit samples are not supported "
                         f"(8-bit only)")
    if colour not in _CHANNELS:
        kind = "palette" if colour == 3 else f"colour type {colour}"
        raise ValueError(f"{path}: {kind} images are not supported")
    if interlace != 0:
        raise ValueError(f"{path}: interlaced images are not supported")
    ch = _CHANNELS[colour]
    stride = width * ch
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < height * (stride + 1):
        raise ValueError(f"{path}: image data is truncated")
    img = _unfilter(raw, height, stride, ch, path)
    return img.reshape(height, width) if ch == 1 else img.reshape(
        height, width, ch)


def read_png(path: str) -> np.ndarray:
    """:func:`decode_png` of the file at ``path``."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """uint8 ``[H, W]`` or ``[H, W, C]`` (C in 1-4) as PNG bytes, every row
    with filter 0."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png: expected uint8, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    ch = 1 if img.ndim == 2 else img.shape[2]
    if img.ndim not in (2, 3) or ch not in (1, 2, 3, 4):
        raise ValueError(f"encode_png: unsupported shape {img.shape}")
    colour = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    h, w = img.shape[:2]
    rows = np.zeros((h, 1 + w * ch), np.uint8)
    rows[:, 1:] = img.reshape(h, w * ch)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    """Write :func:`encode_png` of ``img`` to ``path``."""
    data = encode_png(img, level)
    with open(path, "wb") as f:
        f.write(data)
