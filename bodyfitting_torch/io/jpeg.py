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


# ---------------------------------------------------------------------------
# Encoding: baseline JPEG as libjpeg-turbo writes it under OpenCV's defaults
# ---------------------------------------------------------------------------

# The JPEG standard's example tables (ITU T.81 Annex K), natural order.
_LUMA_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_CHROMA_QUANT = np.full(64, 99)
_CHROMA_QUANT[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])


def _ac_values(prefix):
    """An Annex K AC table's symbols: its irregular head, then every other
    (run, size) symbol in increasing order."""
    rest = sorted({(r << 4) | s for r in range(16) for s in range(1, 11)}
                  - set(prefix))
    return list(prefix) + rest


# (bits per code length 1..16, symbols): DC luma, AC luma, DC / AC chroma
_HUFFMAN = {
    (0, 0): ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12))),
    (1, 0): ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125], _ac_values([
        0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41,
        0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91,
        0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24,
        0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16])),
    (0, 1): ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12))),
    (1, 1): ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119], _ac_values([
        0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12,
        0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14,
        0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15,
        0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1])),
}


def _codes(bits, vals):
    """Canonical Huffman codes: symbol -> (code, length)."""
    out, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            out[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


def _quant_table(base, quality):
    """libjpeg's ``jpeg_add_quant_table`` at ``quality`` (baseline: at most
    255), natural order."""
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return np.clip((base * scale + 50) // 100, 1, 255)


def _quantize(coefs, qtable):
    """libjpeg-turbo's quantization of the ISLOW DCT's output (scaled up by
    8) by ``qtable << 3``: the reciprocal multiply of its
    ``compute_reciprocal``, which rounds half away from zero."""
    out = np.empty_like(coefs)
    for i in range(64):
        d = int(qtable[i]) << 3
        b = d.bit_length() - 1
        r = 16 + b
        fq, fr = divmod(1 << r, d)
        c = d // 2
        if fr == 0:
            fq >>= 1
            r -= 1
        elif fr <= d // 2:
            c += 1
        else:
            fq += 1
        x = coefs[:, i]
        q = ((np.abs(x) + c) * fq) >> r
        out[:, i] = np.where(x < 0, -q, q)
    return out


def _fdct_islow(blocks):
    """libjpeg's ``jpeg_fdct_islow`` on centred samples ``[N, 8, 8]``
    (int64): rows, then columns; the output is scaled up by 8."""
    def descale(x, n):
        return (x + (1 << (n - 1))) >> n

    def one_pass(d, last):
        d0, d1, d2, d3, d4, d5, d6, d7 = (d[..., k] for k in range(8))
        tmp0, tmp7 = d0 + d7, d0 - d7
        tmp1, tmp6 = d1 + d6, d1 - d6
        tmp2, tmp5 = d2 + d5, d2 - d5
        tmp3, tmp4 = d3 + d4, d3 - d4
        tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
        tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
        if last:
            o0, o4, sh = descale(tmp10 + tmp11, 2), descale(tmp10 - tmp11, 2), 15
        else:
            o0, o4, sh = (tmp10 + tmp11) << 2, (tmp10 - tmp11) << 2, 11
        z1 = (tmp12 + tmp13) * 4433
        o2 = descale(z1 + tmp13 * 6270, sh)
        o6 = descale(z1 + tmp12 * -15137, sh)
        z1, z2 = tmp4 + tmp7, tmp5 + tmp6
        z3, z4 = tmp4 + tmp6, tmp5 + tmp7
        z5 = (z3 + z4) * 9633
        tmp4, tmp5 = tmp4 * 2446, tmp5 * 16819
        tmp6, tmp7 = tmp6 * 25172, tmp7 * 12299
        z1, z2 = z1 * -7373, z2 * -20995
        z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
        o7 = descale(tmp4 + z1 + z3, sh)
        o5 = descale(tmp5 + z2 + z4, sh)
        o3 = descale(tmp6 + z2 + z3, sh)
        o1 = descale(tmp7 + z1 + z4, sh)
        return np.stack([o0, o1, o2, o3, o4, o5, o6, o7], -1)

    rows = one_pass(blocks, False)
    return one_pass(rows.swapaxes(-1, -2), True).swapaxes(-1, -2)


def _pad(plane, h, w):
    """``plane`` grown to ``h x w`` by repeating its last row and column,
    as libjpeg's edge expansion does."""
    return np.pad(plane, ((0, h - plane.shape[0]), (0, w - plane.shape[1])),
                  mode="edge")


def _component_blocks(plane, bw, bh, qtable):
    """The quantized zigzag coefficients ``[bh, bw, 64]`` of a component
    plane covering ``bh x bw`` blocks."""
    x = plane[:bh * 8, :bw * 8].astype(np.int64) - 128
    blocks = x.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)
    coefs = _quantize(_fdct_islow(blocks).reshape(-1, 64), qtable)
    return coefs[:, ZIGZAG].reshape(bh, bw, 64)


def encode_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    """A baseline JPEG of ``img`` (uint8 ``[H, W, 3]`` RGB, or ``[H, W]``
    grey) with the bytes libjpeg-turbo writes under OpenCV's
    ``imencode(".jpg")`` defaults: quality 95, 4:2:0 sampling, the
    standard Huffman tables, the ISLOW DCT, a JFIF 1.01 header.  The
    fixed-point colour conversion, the h2v2 downsampling with its
    alternating bias, the edge padding and the DC-only dummy blocks at the
    right and bottom are libjpeg's."""
    img = np.asarray(img, np.uint8)
    H, W = img.shape[:2]
    grey = img.ndim == 2
    luma_q = _quant_table(_LUMA_QUANT, quality)
    chroma_q = _quant_table(_CHROMA_QUANT, quality)
    if grey:
        comps = [(img, 1, 1, 0)]
        mh = mw = 1
    else:
        rgb = img.astype(np.int64)
        R, G, B = rgb[..., 0], rgb[..., 1], rgb[..., 2]

        def fix(x):
            return int(x * 65536 + 0.5)

        half, off = 1 << 15, 128 << 16
        Y = (fix(0.299) * R + fix(0.587) * G + fix(0.114) * B + half) >> 16
        Cb = (-fix(0.16874) * R - fix(0.33126) * G + fix(0.5) * B + off
              + half - 1) >> 16
        Cr = (fix(0.5) * R - fix(0.41869) * G - fix(0.08131) * B + off
              + half - 1) >> 16
        comps = [(Y, 2, 2, 0), (Cb, 1, 1, 1), (Cr, 1, 1, 1)]
        mh = mw = 2
    mcux, mcuy = -(-W // (8 * mw)), -(-H // (8 * mh))
    coefs = []
    for plane, hs, vs, tq in comps:
        bw = -(-W * hs // (mw * 8))           # width_in_blocks
        bh = -(-H * vs // (mh * 8))
        if hs == mw:                          # full-size component
            p = _pad(plane, mcuy * 8 * vs, bw * 8)
        else:                                 # h2v2 downsampling
            p = _pad(plane, -(-H // 2) * 2, bw * 16)
            bias = np.tile([1, 2], bw * 4)
            p = (p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2]
                 + p[1::2, 1::2] + bias) >> 2
            p = _pad(p, mcuy * 8, bw * 8)
        c = _component_blocks(p, bw, bh, luma_q if tq == 0 else chroma_q)
        full = np.zeros((mcuy * vs, mcux * hs, 64), np.int64)
        full[:bh, :bw] = c
        # dummy blocks: DC only, the DC of the block before them in the MCU
        for by in range(mcuy * vs):
            for bx in range(mcux * hs):
                if by < bh and bx < bw:
                    continue
                if by < bh or by % vs == 0:       # right of the image
                    src = full[by, bx - 1, 0]
                else:                             # a row under the image
                    src = full[by - 1, (bx // hs) * hs + hs - 1, 0]
                full[by, bx, 0] = src
        coefs.append((full, hs, vs, tq))

    codes = {k: _codes(*v) for k, v in _HUFFMAN.items()}
    out_codes, out_lens = [], []

    def emit(code, length):
        out_codes.append(code)
        out_lens.append(length)

    last_dc = [0] * len(coefs)
    for my in range(mcuy):
        for mx in range(mcux):
            for ci, (full, hs, vs, tq) in enumerate(coefs):
                dc_tab, ac_tab = codes[0, tq], codes[1, tq]
                for y in range(vs):
                    for x in range(hs):
                        blk = full[my * vs + y, mx * hs + x]
                        diff = int(blk[0]) - last_dc[ci]
                        last_dc[ci] = int(blk[0])
                        n = abs(diff).bit_length()
                        emit(*dc_tab[n])
                        if n:
                            emit((diff if diff >= 0 else diff - 1)
                                 & ((1 << n) - 1), n)
                        prev = 0
                        for k in np.flatnonzero(blk[1:]) + 1:
                            r = int(k) - prev - 1
                            while r > 15:
                                emit(*ac_tab[0xF0])
                                r -= 16
                            v = int(blk[k])
                            n = abs(v).bit_length()
                            emit(*ac_tab[(r << 4) | n])
                            emit((v if v >= 0 else v - 1) & ((1 << n) - 1), n)
                            prev = int(k)
                        if prev < 63:
                            emit(*ac_tab[0x00])
    data = _pack_bits(np.array(out_codes, np.int64),
                      np.array(out_lens, np.int64))
    return _jpeg_headers(H, W, coefs, luma_q, chroma_q, grey) + data + \
        b"\xff\xd9"


def _pack_bits(codes, lens):
    """Entropy-coded bytes: the codes' bits MSB first, padded with ones to
    a byte, each 0xFF byte stuffed with a 0x00."""
    total = int(lens.sum())
    idx = np.repeat(np.arange(len(codes)), lens)
    start = np.repeat(np.cumsum(lens) - lens, lens)
    k = np.arange(total) - start
    bits = (codes[idx] >> (lens[idx] - 1 - k)) & 1
    pad = (-total) % 8
    bits = np.concatenate([bits, np.ones(pad, np.int64)]).astype(np.uint8)
    raw = np.packbits(bits)
    ff = np.flatnonzero(raw == 0xFF)
    return np.insert(raw, ff + 1, 0).tobytes()


def _jpeg_headers(H, W, coefs, luma_q, chroma_q, grey):
    """SOI, JFIF APP0, one DQT a table, SOF0, one DHT a table, SOS."""
    def seg(marker, payload):
        return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload

    out = b"\xff\xd8" + seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01"
                            b"\x00\x00")
    tables = [luma_q] if grey else [luma_q, chroma_q]
    for i, q in enumerate(tables):
        out += seg(0xDB, bytes([i]) + bytes(int(v) for v in q[ZIGZAG]))
    sof = struct.pack(">BHHB", 8, H, W, len(coefs))
    for ci, (_, hs, vs, tq) in enumerate(coefs):
        sof += bytes([ci + 1, (hs << 4) | vs, tq])
    out += seg(0xC0, sof)
    for tq in range(len(tables)):
        for tc in (0, 1):
            bits, vals = _HUFFMAN[tc, tq]
            out += seg(0xC4, bytes([(tc << 4) | tq] + bits + vals))
    sos = bytes([len(coefs)])
    for ci, (_, _, _, tq) in enumerate(coefs):
        sos += bytes([ci + 1, (tq << 4) | tq])
    return out + seg(0xDA, sos + b"\x00\x3f\x00")
