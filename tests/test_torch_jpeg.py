"""The port's JPEG decoder (``io/jpeg.py``, ``ops/csrc/jpeg_decode.cpp``)
against ``cv2.imread`` and the JAX package's ``imread_checked`` on JPEGs
that OpenCV encodes here.

Every comparison is exact (equal arrays): the decoder reproduces
libjpeg-turbo's default path (ISLOW IDCT, fancy upsampling, fixed-point
colour conversion) that OpenCV decodes with.  Cases: every chroma
sampling the scope covers and grey, three qualities, baseline,
optimised-Huffman and progressive coding, a restart interval, odd sizes,
EXIF orientations under both flags, the committed fixtures; and the
streams the port refuses (arithmetic coding, 12-bit, lossless, CMYK,
4:1:1, truncated or corrupt data), each with the file's name.
"""

import hashlib
import itertools
import json
import os
import struct

import cv2
import numpy as np
import pytest

from bodyfitting_tpu.io import images as jimg
from bodyfitting_torch.io import images as pimg
from bodyfitting_torch.io.jpeg import decode_jpeg, exif_orientation

FIXTURES = os.path.join(os.path.dirname(__file__), "data", "jpeg")
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "grey": None}
MODES = {"baseline": [], "optimised": [cv2.IMWRITE_JPEG_OPTIMIZE, 1],
         "progressive": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
         "restart": [cv2.IMWRITE_JPEG_RST_INTERVAL, 2]}
SIZES = ((1, 1), (17, 33), (250, 3), (64, 48))
FLAGS = (pimg.IMREAD_COLOR, pimg.IMREAD_UNCHANGED)


def _image(h, w, channels, seed=0):
    """Smooth bands with noise: every block carries AC energy."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(xx / 5.0 + k) * np.cos(yy / 4.0 + 2 * k)
                    for k in range(channels)], -1)
    img = img + rng.normal(0.0, 18.0, img.shape)
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 0] if channels == 1 else img


def _encode(img, sampling, quality, mode):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality] + MODES[mode]
    if SAMPLING[sampling] is not None:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def _check_file(path):
    """``imread_checked`` under both flags equals cv2 and the JAX reader."""
    for flags in FLAGS:
        ref = cv2.imread(path, flags)
        got = pimg.imread_checked(path, flags)
        assert got.dtype == np.uint8 and got.shape == ref.shape, flags
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, jimg.imread_checked(path, flags))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_decode_equals_opencv(tmp_path, sampling, mode):
    for q, (h, w) in itertools.product((50, 95, 100), SIZES):
        img = _image(h, w, 1 if sampling == "grey" else 3, seed=h + q)
        data = _encode(img, sampling, q, mode)
        ref = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
        got = decode_jpeg(data, "x.jpg")
        if got.ndim == 3:
            got = got[..., ::-1]                            # RGB -> BGR
        assert got.shape == ref.shape, (q, h, w)
        np.testing.assert_array_equal(got, ref, err_msg=f"q {q} {h}x{w}")
    path = str(tmp_path / "img.jpg")
    open(path, "wb").write(data)
    _check_file(path)


def _with_exif(data: bytes, orientation: int, big_endian: bool) -> bytes:
    """``data`` with an APP1 EXIF segment after SOI whose IFD0 holds the
    orientation tag (and one other tag before it)."""
    e = ">" if big_endian else "<"
    head = b"MM\x00*" if big_endian else b"II*\x00"
    entries = [struct.pack(e + "HHI4s", 0x010F, 2, 4, b"cam\x00"),
               struct.pack(e + "HHIH2x", 0x0112, 3, 1, orientation)]
    tiff = (head + struct.pack(e + "I", 8) + struct.pack(e + "H", len(entries))
            + b"".join(entries) + struct.pack(e + "I", 0))
    body = b"Exif\x00\x00" + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body \
        + data[2:]


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_as_opencv(tmp_path, orientation):
    """cv2 turns the image upright under IMREAD_COLOR and leaves it as
    stored under IMREAD_UNCHANGED; so does ``imread_checked``."""
    for big, sampling in ((False, "420"), (True, "grey")):
        img = _image(17, 33, 1 if sampling == "grey" else 3, seed=orientation)
        data = _with_exif(_encode(img, sampling, 90, "baseline"), orientation,
                          big)
        assert exif_orientation(data) == orientation
        path = str(tmp_path / f"o{orientation}{big}.jpg")
        open(path, "wb").write(data)
        _check_file(path)
        if orientation > 4:        # transposed under IMREAD_COLOR only
            assert pimg.imread_checked(path).shape[:2] == (33, 17)
            assert pimg.imread_checked(
                path, pimg.IMREAD_UNCHANGED).shape[:2] == (17, 33)


def test_committed_fixtures_decode_to_their_recorded_sha1():
    """The fixtures ``chip_smoke.py`` decodes on the card: cv2's decode
    still has the recorded sha1, and the port's decode equals it."""
    record = json.load(open(os.path.join(FIXTURES, "fixtures.json")))
    assert set(record) == {"texture_2048.jpg", "progressive_256.jpg"}
    for name, rec in record.items():
        path = os.path.join(FIXTURES, name)
        ref = cv2.imread(path, cv2.IMREAD_COLOR)
        got = pimg.imread_checked(path)
        assert list(got.shape) == rec["shape"]
        assert hashlib.sha1(ref.tobytes()).hexdigest() == rec["sha1"]
        assert hashlib.sha1(got.tobytes()).hexdigest() == rec["sha1"]
    total = sum(os.path.getsize(os.path.join(FIXTURES, n)) for n in record)
    assert total < 1 << 20


def _segments(data: bytes):
    """``(marker, offset)`` of every marker segment before the first SOS."""
    pos, out = 2, []
    while data[pos] == 0xFF:
        m = data[pos + 1]
        out.append((m, pos))
        if m == 0xDA:
            break
        pos += 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
    return out


def _patched_sof(data: bytes, marker=None, precision=None) -> bytes:
    b = bytearray(data)
    pos = next(p for m, p in _segments(data) if m in (0xC0, 0xC2))
    if marker is not None:
        b[pos + 1] = marker
    if precision is not None:
        b[pos + 4] = precision
    return bytes(b)


def _cmyk_header(data: bytes) -> bytes:
    """``data``'s SOF rewritten to declare four components (the
    Adobe-style CMYK layout: ids 1-4, 1x1 sampling)."""
    pos = next(p for m, p in _segments(data) if m == 0xC0)
    n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
    h, w = struct.unpack(">HH", data[pos + 5:pos + 9])
    comps = b"".join(bytes([i, 0x11, 0]) for i in range(1, 5))
    sof = (b"\xff\xc0" + struct.pack(">HBHHB", 8 + 12, 8, h, w, 4) + comps)
    return data[:pos] + sof + data[pos + 2 + n:]


REFUSALS = {
    "arithmetic": (lambda d: _patched_sof(d, marker=0xC9), "arithmetic"),
    "12-bit": (lambda d: _patched_sof(d, precision=12), "12-bit"),
    "lossless": (lambda d: _patched_sof(d, marker=0xC3), "lossless"),
    "cmyk": (_cmyk_header, "CMYK"),
    "truncated": (lambda d: d[:len(d) // 2], "truncated"),
    "no-eoi": (lambda d: d[:-2], "truncated"),
    "corrupt": (lambda d: d[:-40] + b"\xff\xd3" + d[-38:], "corrupt"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refused_streams_raise_naming_the_file(tmp_path, case):
    make, what = REFUSALS[case]
    data = make(_encode(_image(40, 56, 3), "420", 90, "baseline"))
    path = str(tmp_path / f"{case}.jpg")
    open(path, "wb").write(data)
    with pytest.raises(ValueError, match=f"{case}.jpg.*{what}"):
        decode_jpeg(data, path)
    with pytest.raises(FileNotFoundError, match=f"{case}.jpg"):
        pimg.imread_checked(path)


def test_sampling_above_two_is_refused():
    data = _encode(_image(16, 40, 3), "444", 90, "baseline")
    ok, buf = cv2.imencode(".jpg", _image(16, 40, 3), [
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411])
    assert ok
    with pytest.raises(ValueError, match="411.jpg: sampling factors"):
        decode_jpeg(buf.tobytes(), "411.jpg")
    with pytest.raises(ValueError, match="not a JPEG"):
        decode_jpeg(data[2:], "y.jpg")
