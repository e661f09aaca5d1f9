"""JPEG reading without OpenCV, imageio or PIL.

The port's stand-in for ``cv2.imread`` on JPEG files (the machine with the
card has none of those libraries).  The decoder is host C++
(``ops/csrc/jpeg_decode.cpp``, built at first use): Huffman-coded 8-bit
baseline, extended sequential and progressive images of 1 or 3
components, sampled 4:4:4, 4:2:2, 4:4:0 or 4:2:0, with restart intervals.
It gives the pixels libjpeg-turbo's defaults give (the ISLOW IDCT, fancy
upsampling, fixed-point YCbCr -> RGB), which ``cv2.imread`` returns.  Other
JPEGs (arithmetic coding, 12-bit, lossless, CMYK) and truncated or corrupt
streams raise ``ValueError`` naming the file: libjpeg-turbo pads a
truncated stream and converts CMYK, this port refuses both.

:func:`exif_orientation` reads the APP1 EXIF orientation tag and
:func:`apply_orientation` turns an image upright as ``cv2.imread`` does
under ``IMREAD_COLOR``.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

SIGNATURE = b"\xff\xd8\xff"


def _decoder():
    from bodyfitting_torch.ops.kernels import _build

    lib = _build.library("jpeg_decode")
    fn = lib.jpeg_decode
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                       ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                       ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_int),
                       ctypes.c_char_p, ctypes.c_int]
        fn.restype = ctypes.c_int
        lib.jpeg_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        lib.jpeg_free.restype = None
    return lib


def decode_jpeg(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """The image in JPEG ``data`` as stored (no EXIF rotation): uint8
    ``[H, W]`` for one component, ``[H, W, 3]`` RGB for three."""
    lib = _decoder()
    out = ctypes.POINTER(ctypes.c_uint8)()
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(256)
    rc = lib.jpeg_decode(bytes(data), len(data), ctypes.byref(out),
                         ctypes.byref(w), ctypes.byref(h), ctypes.byref(c),
                         err, len(err))
    if rc != 0:
        raise ValueError(f"{path}: {err.value.decode(errors='replace')}")
    try:
        n = h.value * w.value * c.value
        img = np.ctypeslib.as_array(out, shape=(n,)).copy()
    finally:
        lib.jpeg_free(out)
    shape = (h.value, w.value) + ((c.value,) if c.value > 1 else ())
    return img.reshape(shape)


def exif_orientation(data: bytes) -> int:
    """The EXIF orientation tag (1-8) of JPEG ``data``'s APP1 segment; 1
    when there is none."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker == 0xDA or marker == 0xD9:         # SOS, EOI: no EXIF
            break
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        body = data[pos + 4:pos + 2 + length]
        if marker == 0xE1 and body[:6] == b"Exif\x00\x00":
            return _tiff_orientation(body[6:])
        pos += 2 + length
    return 1


def _tiff_orientation(tiff: bytes) -> int:
    if tiff[:4] == b"II*\x00":
        e = "<"
    elif tiff[:4] == b"MM\x00*":
        e = ">"
    else:
        return 1
    try:
        ifd = struct.unpack(e + "I", tiff[4:8])[0]
        count = struct.unpack(e + "H", tiff[ifd:ifd + 2])[0]
        for i in range(count):
            ent = tiff[ifd + 2 + 12 * i:ifd + 14 + 12 * i]
            tag, kind = struct.unpack(e + "HH", ent[:4])
            if tag == 0x0112 and kind == 3:
                return struct.unpack(e + "H", ent[8:10])[0]
    except struct.error:                 # a cut or malformed IFD: no tag
        return 1
    return 1


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """``img`` turned upright for an EXIF ``orientation``, as OpenCV's
    ``ApplyExifOrientation`` does (flips and a transpose)."""
    if orientation in (5, 6, 7, 8):
        img = img.swapaxes(0, 1)
    if orientation in (2, 3, 6, 7):
        img = img[:, ::-1]                               # horizontal flip
    if orientation in (3, 4, 7, 8):
        img = img[::-1]                                  # vertical flip
    return np.ascontiguousarray(img)
