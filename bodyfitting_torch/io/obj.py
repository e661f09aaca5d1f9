"""Wavefront OBJ reading and writing: scans, UV templates and the outputs.

Counterpart of ``bodyfitting_tpu/io/obj.py``.  :func:`load_obj` parses
with host C++ (``ops/csrc/obj_parse.cpp``, the port's copy of the JAX
package's native parser; built at first use, and a failed build raises:
a RenderPeople scan is about a million lines, too many for a Python
loop), with the MTL's ``map_Kd`` texture read through
:func:`bodyfitting_torch.io.images.imread_checked` (PNG or JPEG).
:func:`save_obj` writes the plain ``v %.4f`` / 1-based ``f`` format and
:func:`save_obj_uv` the textured OBJ + MTL + PNG, each byte for byte as
the JAX writers do (the PNG's pixels equal, its bytes those of
``io/png.py``).  One ``%`` over the whole array formats a mesh in
milliseconds.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import warnings
from typing import Optional

import numpy as np


@dataclasses.dataclass
class ObjMesh:
    verts: np.ndarray                       # [V, 3] float32
    faces: np.ndarray                       # [F, 3] int32
    uvs: Optional[np.ndarray] = None        # [T, 2] float32 (vt entries)
    face_uvs: Optional[np.ndarray] = None   # [F, 3] int32 into uvs
    normals: Optional[np.ndarray] = None    # [N, 3]
    face_normals: Optional[np.ndarray] = None  # [F, 3] int32 into normals
    texture: Optional[np.ndarray] = None    # [H, W, 3] float32 in [0, 1]
    mtl_name: Optional[str] = None


def _load_mtl_texture(mtl_path: str):
    """The MTL file's diffuse texture (the last token of its last
    ``map_Kd`` line) as RGB float32 in [0, 1]; ``None`` when the MTL, the
    line or a readable image is missing (where ``cv2.imread`` gives
    ``None``)."""
    from bodyfitting_torch.io.images import IMREAD_COLOR, imread_checked

    if not os.path.exists(mtl_path):
        return None
    tex_file = None
    with open(mtl_path) as f:
        for line in f:
            parts = line.split()
            if parts and parts[0] == "map_Kd":
                tex_file = parts[-1]
    if tex_file is None:
        return None
    try:
        img = imread_checked(os.path.join(os.path.dirname(mtl_path),
                                          tex_file), IMREAD_COLOR)
    except FileNotFoundError:
        return None
    return img[..., ::-1].astype(np.float32) / 255.0      # BGR -> RGB


def _parse(path: str):
    from bodyfitting_torch.ops.kernels import _build

    lib = _build.library("obj_parse")
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    i64 = ctypes.POINTER(ctypes.c_int64)
    if lib.parse_obj.argtypes is None:
        lib.parse_obj.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(fp), i64, ctypes.POINTER(fp), i64,
            ctypes.POINTER(fp), i64, ctypes.POINTER(ip), ctypes.POINTER(ip),
            ctypes.POINTER(ip), i64, ctypes.c_char_p]
        lib.parse_obj.restype = ctypes.c_int
        lib.free_f32.argtypes = [fp]
        lib.free_f32.restype = None
        lib.free_i32.argtypes = [ip]
        lib.free_i32.restype = None
    verts_p, uvs_p, norms_p = fp(), fp(), fp()
    faces_p, fuv_p, fn_p = ip(), ip(), ip()
    nv, nu, nn, nf = (ctypes.c_int64() for _ in range(4))
    mtl = ctypes.create_string_buffer(256)
    rc = lib.parse_obj(os.fsencode(path), ctypes.byref(verts_p),
                       ctypes.byref(nv), ctypes.byref(uvs_p), ctypes.byref(nu),
                       ctypes.byref(norms_p), ctypes.byref(nn),
                       ctypes.byref(faces_p), ctypes.byref(fuv_p),
                       ctypes.byref(fn_p), ctypes.byref(nf), mtl)
    if rc != 0:
        raise OSError(f"cannot read OBJ file: {path} (parse_obj code {rc})")

    def take(ptr, n, cols, free):
        try:
            if n == 0:
                return None
            return np.ctypeslib.as_array(ptr, shape=(n * cols,)).copy(
                ).reshape(n, cols)
        finally:
            free(ptr)

    return (take(verts_p, nv.value, 3, lib.free_f32),
            take(uvs_p, nu.value, 2, lib.free_f32),
            take(norms_p, nn.value, 3, lib.free_f32),
            take(faces_p, nf.value, 3, lib.free_i32),
            take(fuv_p, nf.value, 3, lib.free_i32),
            take(fn_p, nf.value, 3, lib.free_i32),
            mtl.value.decode() or None)


def _drop_partial(rows, kind: str, path: str):
    """A faces-aligned index array, or ``None`` when no face or only some
    faces carry ``kind`` indices (-1 rows): partial coverage cannot pair
    with the faces downstream, so it is dropped with a warning."""
    if rows is None or not (rows < 0).any():
        return rows
    if not (rows < 0).all():
        warnings.warn(f"{path}: {int((rows < 0).any(1).sum())}/{len(rows)} "
                      f"faces lack {kind} indices; dropping per-face {kind} "
                      f"entirely")
    return None


def load_obj(path: str, load_texture: bool = False) -> ObjMesh:
    """Parse an OBJ file: polygons triangulated as a fan, like the
    reference; with ``load_texture`` the ``mtllib``'s diffuse texture."""
    verts, uvs, normals, faces, face_uvs, face_normals, mtl = _parse(path)
    texture = None
    if load_texture and mtl is not None:
        texture = _load_mtl_texture(os.path.join(os.path.dirname(path), mtl))
    return ObjMesh(
        verts=verts if verts is not None else np.zeros((0, 3), np.float32),
        faces=faces if faces is not None else np.zeros((0, 3), np.int32),
        uvs=uvs, face_uvs=_drop_partial(face_uvs, "vt", path),
        normals=normals, face_normals=_drop_partial(face_normals, "vn", path),
        texture=texture, mtl_name=mtl)


def obj_text(verts: np.ndarray, faces: np.ndarray) -> str:
    """The OBJ file's text for ``verts [V, 3]`` and 0-based ``faces
    [F, 3]``."""
    v = np.asarray(verts).reshape(-1, 3)
    f = np.asarray(faces).reshape(-1, 3).astype(np.int64) + 1
    return (("v %.4f %.4f %.4f\n" * len(v)) % tuple(v.ravel().tolist())
            + ("f %d %d %d\n" * len(f)) % tuple(f.ravel().tolist()))


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    """Write ``verts`` and ``faces`` as an OBJ file."""
    with open(path, "w") as fh:
        fh.write(obj_text(verts, faces))


def save_obj_uv(path: str, verts: np.ndarray, faces: np.ndarray,
                uvs: np.ndarray, face_uvs: np.ndarray,
                texture: Optional[np.ndarray] = None,
                mtl_name: str = "material_0") -> None:
    """Textured mesh writer: the OBJ (``mtllib``, ``v``, ``vt``,
    ``usemtl``, ``f v/vt`` lines), its MTL and, with ``texture`` (RGB
    float in [0, 1]), the texture as a PNG named by the MTL's ``map_Kd``
    next to the OBJ."""
    from bodyfitting_torch.io.png import write_png

    base = os.path.splitext(path)[0]
    obj_dir = os.path.dirname(path)
    mtl_path = base + ".mtl"
    tex_path = base + ".png"
    v = np.asarray(verts).reshape(-1, 3)
    vt = np.asarray(uvs).reshape(-1, 2)
    f = np.asarray(faces).reshape(-1, 3).astype(np.int64) + 1
    fu = np.asarray(face_uvs).reshape(-1, 3).astype(np.int64) + 1
    corners = np.stack([f, fu], -1).reshape(-1, 6)
    with open(path, "w") as fh:
        fh.write(f"mtllib {os.path.relpath(mtl_path, obj_dir)}\n")
        fh.write(("v %.4f %.4f %.4f\n" * len(v)) % tuple(v.ravel().tolist()))
        fh.write(("vt %.6f %.6f\n" * len(vt)) % tuple(vt.ravel().tolist()))
        fh.write(f"usemtl {mtl_name}\n")
        fh.write(("f %d/%d %d/%d %d/%d\n" * len(corners))
                 % tuple(corners.ravel().tolist()))
    with open(mtl_path, "w") as fh:
        fh.write(f"newmtl {mtl_name}\n")
        fh.write("Ka 1.000 1.000 1.000\nKd 1.000 1.000 1.000\n")
        fh.write("Ks 0.000 0.000 0.000\n")
        if texture is not None:
            fh.write(f"map_Kd {os.path.relpath(tex_path, obj_dir)}\n")
    if texture is not None:
        img = np.clip(np.asarray(texture) * 255.0, 0, 255).astype(np.uint8)
        write_png(tex_path, img)
