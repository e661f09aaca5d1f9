"""Binary RGBD ``.stream`` capture files: reading and writing.

Counterpart of ``bodyfitting_tpu/io/rgbd_stream.py``, byte for byte the
same format (little-endian):

  header: frame_count i32, color (w, h, c) 3x i32, depth (w, h, c) 3x i32,
          2 x intrinsics blocks (3x3 f32 matrix + 10 f32 distortion:
          k1..k6, p1, p2, codx, cody), extrinsics 4x4 f32 (depth->color)
  frame:  color_ts u64, color_size u64, jpg bytes[color_size],
          depth_ts u64, depth bytes[dw*dh*dc], index bytes[dw*dh]

The colour JPEGs are decoded by the port's decoder (``io/jpeg.py``, the
pixels ``cv2.imdecode`` gives) and written by its encoder (the bytes
``cv2.imencode(".jpg")`` writes), so a stream written by either package
reads back in the other, and a write is byte-equal.  Host numpy only.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Optional

import numpy as np

from bodyfitting_torch.io.jpeg import decode_jpeg, encode_jpeg

_HEADER_FMT = "<7i"


@dataclasses.dataclass
class StreamIntrinsics:
    matrix: np.ndarray            # [3, 3] float32
    coeffs: np.ndarray            # [10] k1..k6, p1, p2, codx, cody


@dataclasses.dataclass
class RGBDFrame:
    color: np.ndarray             # [H, W, 3] uint8, BGR (as OpenCV's)
    color_timestamp: int
    depth_raw: np.ndarray         # [dh, dw, dc] uint8
    depth16: np.ndarray           # [dh, dw] uint16
    depth_timestamp: int
    index: np.ndarray             # [dh, dw] uint8 segmentation ids


class RGBDStreamDecoder:
    """Random-access reader over a ``.stream`` capture file.  Frames cut
    short at the end of the file (a recorder killed mid-frame) are
    dropped."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        self._parse()

    def _read(self, fmt):
        return struct.unpack(fmt, self._f.read(struct.calcsize(fmt)))

    def _read_intrinsics(self) -> StreamIntrinsics:
        vals = self._read("<19f")
        return StreamIntrinsics(
            matrix=np.asarray(vals[:9], np.float32).reshape(3, 3),
            coeffs=np.asarray(vals[9:], np.float32))

    def _frame_end(self, start: int, file_size: int) -> Optional[int]:
        """Where the frame at ``start`` ends, or None when its header or
        payload runs past the end of the file."""
        if start + 16 > file_size:
            return None
        self._f.seek(start)
        _, color_sz = self._read("<QQ")
        end = start + 3 * 8 + color_sz + self.depth_size + self.index_size
        return end if end <= file_size else None

    def _parse(self):
        (self.frame_count, self.color_width, self.color_height,
         self.color_channels, self.depth_width, self.depth_height,
         self.depth_channels) = self._read(_HEADER_FMT)
        if self.frame_count == 0:
            self.frame_count = 9999
        self.depth_size = (self.depth_width * self.depth_height
                           * self.depth_channels)
        self.index_size = self.depth_width * self.depth_height
        self.color_intrinsics = self._read_intrinsics()
        self.depth_intrinsics = self._read_intrinsics()
        self.depth2color = np.asarray(self._read("<16f"),
                                      np.float32).reshape(4, 4)
        file_size = os.path.getsize(self.path)
        offsets = []
        start = struct.calcsize(_HEADER_FMT) + 2 * 19 * 4 + 16 * 4
        while len(offsets) < self.frame_count:
            end = self._frame_end(start, file_size)
            if end is None:
                break
            offsets.append(start)
            start = end
        self.frame_offsets = offsets
        self.frame_count = len(offsets)

    def get_frame(self, idx: int) -> Optional[RGBDFrame]:
        if idx >= len(self.frame_offsets):
            return None
        self._f.seek(self.frame_offsets[idx])
        color_ts, color_sz = self._read("<QQ")
        color = decode_jpeg(self._f.read(color_sz), self.path)
        if color.ndim == 2:                   # IMREAD_COLOR: 3 channels
            color = np.repeat(color[..., None], 3, axis=2)
        color = np.ascontiguousarray(color[..., ::-1])
        (depth_ts,) = self._read("<Q")
        depth_bytes = self._f.read(self.depth_size)
        index_bytes = self._f.read(self.index_size)
        return RGBDFrame(
            color=color, color_timestamp=color_ts,
            depth_raw=np.frombuffer(depth_bytes, np.uint8).reshape(
                self.depth_height, self.depth_width, self.depth_channels),
            depth16=np.frombuffer(depth_bytes, np.uint16).reshape(
                self.depth_height, self.depth_width),
            depth_timestamp=depth_ts,
            index=np.frombuffer(index_bytes, np.uint8).reshape(
                self.depth_height, self.depth_width))

    def close(self):
        self._f.close()


def write_rgbd_stream(path: str, colors, depths16, indices,
                      color_intrinsics: Optional[StreamIntrinsics] = None,
                      depth_intrinsics: Optional[StreamIntrinsics] = None,
                      depth2color: Optional[np.ndarray] = None,
                      timestamps=None) -> None:
    """Encode frames into the ``.stream`` format: ``colors`` uint8 BGR
    ``[H, W, 3]`` (or grey ``[H, W]``), ``depths16`` uint16 ``[dh, dw]``,
    ``indices`` uint8 ``[dh, dw]``; the timestamps default to the frame
    numbers, the intrinsics to identities."""
    colors = list(colors)
    depths16 = [np.asarray(d, np.uint16) for d in depths16]
    indices = [np.asarray(i, np.uint8) for i in indices]
    ch, cw = colors[0].shape[:2]
    dh, dw = depths16[0].shape
    default_K = StreamIntrinsics(matrix=np.eye(3, dtype=np.float32),
                                 coeffs=np.zeros(10, np.float32))
    ci = color_intrinsics or default_K
    di = depth_intrinsics or default_K
    ext = (depth2color if depth2color is not None
           else np.eye(4, dtype=np.float32))
    has_ts = timestamps is not None and len(timestamps) > 0
    with open(path, "wb") as f:
        f.write(struct.pack(_HEADER_FMT, len(colors), cw, ch, 3, dw, dh, 2))
        for intr in (ci, di):
            f.write(struct.pack(
                "<19f", *np.asarray(intr.matrix, np.float32).reshape(-1),
                *np.asarray(intr.coeffs, np.float32)))
        f.write(struct.pack("<16f", *np.asarray(ext, np.float32).reshape(-1)))
        for i, (c, d, ix) in enumerate(zip(colors, depths16, indices)):
            ts = int(timestamps[i]) if has_ts else i
            c = np.asarray(c, np.uint8)
            jpg = encode_jpeg(c if c.ndim == 2 else c[..., ::-1])
            f.write(struct.pack("<QQ", ts, len(jpg)))
            f.write(jpg)
            f.write(struct.pack("<Q", ts))
            f.write(d.tobytes())
            f.write(ix.tobytes())


def read_rgbd(path: str, read_color=True, read_depth=False, read_mask=False):
    """Every frame's colour, depth and index maps, as lists."""
    dec = RGBDStreamDecoder(path)
    colors, depths, masks = [], [], []
    for i in range(dec.frame_count):
        fr = dec.get_frame(i)
        if fr is None:
            break
        if read_color:
            colors.append(fr.color)
        if read_depth:
            depths.append(fr.depth16)
        if read_mask:
            masks.append(fr.index)
    dec.close()
    return colors, depths, masks
