"""The port's OBJ reading and writing (``io/obj.py`` with the host C++
parser ``ops/csrc/obj_parse.cpp``, ``io/scan_prep.py``) against the JAX
package's ``io/obj.py`` (its native and its pure-Python parser) and
``io/scan_prep.py``.

Every comparison is exact: arrays equal to both JAX routes (values
written with ``%.6f`` parse to the same float32 in ``strtof`` and in
Python's ``float``), files equal byte for byte, and the textures' PNGs
(the port writes its own, the JAX writer through OpenCV) equal pixel
for pixel.
"""

import os
import warnings

import cv2
import numpy as np
import pytest

from bodyfitting_tpu.io import obj as jobj
from bodyfitting_tpu.io import scan_prep as jprep
from bodyfitting_tpu.utils import uv_unwrap as juv
from bodyfitting_torch.io import obj as pobj
from bodyfitting_torch.io import scan_prep as pprep
from bodyfitting_torch.io.png import read_png
from bodyfitting_torch.utils import uv_unwrap as puv

FIELDS = ("verts", "faces", "uvs", "face_uvs", "normals", "face_normals",
          "texture")


def _mesh_text(form: str, rng) -> str:
    """Six vertices, uvs and normals, then a triangle, a quad, a pentagon
    and a negative-index quad, every corner in ``form``."""
    lines = ["# a hand-made mesh", "mtllib mesh.mtl", "o body"]
    lines += ["v %.6f %.6f %.6f" % tuple(p) for p in rng.normal(size=(6, 3))]
    lines += ["vt %.6f %.6f" % tuple(p) for p in rng.uniform(size=(6, 2))]
    lines += ["vn %.6f %.6f %.6f" % tuple(p) for p in rng.normal(size=(6, 3))]
    lines += ["# faces", "usemtl material_0", "s off"]

    def corner(i):
        return {"v": f"{i}", "v/vt": f"{i}/{i}", "v//vn": f"{i}//{i}",
                "v/vt/vn": f"{i}/{i}/{i}"}[form]

    for poly in ((1, 2, 3), (1, 3, 4, 5), (2, 3, 4, 5, 6), (-4, -3, -2, -1)):
        lines.append("f " + " ".join(corner(i) for i in poly))
    return "\n".join(lines) + "\n"


def _assert_same(port, ref, fields=FIELDS):
    for k in fields:
        a, b = getattr(port, k), getattr(ref, k)
        assert (a is None) == (b is None), k
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)


def _both_jax(path, load_texture=False):
    return [jobj.load_obj(path, load_texture=load_texture, use_native=n)
            for n in (True, False)]


@pytest.mark.parametrize("form", ["v", "v/vt", "v//vn", "v/vt/vn"])
def test_load_obj_matches_both_jax_routes(tmp_path, form):
    path = str(tmp_path / "mesh.obj")
    open(path, "w").write(_mesh_text(form, np.random.default_rng(0)))
    got = pobj.load_obj(path)
    native, python = _both_jax(path)
    for ref in (native, python):
        _assert_same(got, ref)
    assert got.faces.shape == (1 + 2 + 3 + 2, 3)
    assert got.mtl_name == native.mtl_name == "mesh.mtl"
    assert (got.face_uvs is None) == ("vt" not in form)
    assert (got.face_normals is None) == ("vn" not in form)


def test_partial_uvs_warn_and_drop(tmp_path):
    path = str(tmp_path / "partial.obj")
    text = _mesh_text("v/vt", np.random.default_rng(1))
    open(path, "w").write(text + "f 1 2 6\n")
    with pytest.warns(UserWarning, match="partial.obj: 1/9 faces lack vt"):
        got = pobj.load_obj(path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        refs = _both_jax(path)
    assert got.face_uvs is None and got.uvs is not None
    for ref in refs:
        _assert_same(got, ref)


@pytest.mark.parametrize("kind", ["png", "jpg", "missing"])
def test_mtl_texture_matches_jax(tmp_path, kind):
    rng = np.random.default_rng(2)
    path = str(tmp_path / "mesh.obj")
    open(path, "w").write(_mesh_text("v/vt", rng))
    tex = rng.integers(0, 256, (24, 40, 3)).astype(np.uint8)
    name = f"tex/diffuse.{'png' if kind == 'missing' else kind}"
    # the last token of the last map_Kd line names the file
    open(tmp_path / "mesh.mtl", "w").write(
        "newmtl material_0\nmap_Kd old.png\nmap_Kd -bm 1.0 " + name + "\n")
    if kind != "missing":
        os.makedirs(tmp_path / "tex")
        assert cv2.imwrite(str(tmp_path / name), tex)
    got = pobj.load_obj(path, load_texture=True)
    for ref in _both_jax(path, load_texture=True):
        _assert_same(got, ref)
    if kind == "missing":
        assert got.texture is None
    else:
        assert got.texture.dtype == np.float32
        assert got.texture.shape == (24, 40, 3)


def test_save_obj_uv_and_uv_template_write_the_jax_files(tmp_path):
    rng = np.random.default_rng(3)
    verts = rng.normal(size=(30, 3)).astype(np.float32)
    faces = rng.integers(0, 30, size=(40, 3)).astype(np.int32)
    uvs = rng.uniform(size=(50, 2)).astype(np.float32)
    face_uvs = rng.integers(0, 50, size=(40, 3)).astype(np.int32)
    tex = rng.uniform(-0.1, 1.1, size=(20, 12, 3)).astype(np.float32)
    for tag, mod in (("port", pobj), ("jax", jobj)):
        os.makedirs(tmp_path / tag)
        mod.save_obj_uv(str(tmp_path / tag / "m.obj"), verts, faces, uvs,
                        face_uvs, texture=tex, mtl_name="skin")
        mod.save_obj_uv(str(tmp_path / tag / "plain.obj"), verts, faces, uvs,
                        face_uvs)
    tpl = {tag: mod.make_uv_template(verts, faces,
                                     str(tmp_path / tag / "tpl.obj"))
           for tag, mod in (("port", puv), ("jax", juv))}
    for a, b in zip(tpl["port"], tpl["jax"]):
        np.testing.assert_array_equal(a, b)
    for name in ("m.obj", "m.mtl", "plain.obj", "plain.mtl", "tpl.obj",
                 "tpl.mtl"):
        assert (open(tmp_path / "port" / name, "rb").read()
                == open(tmp_path / "jax" / name, "rb").read()), name
    assert not (tmp_path / "port" / "plain.png").exists()
    np.testing.assert_array_equal(
        read_png(str(tmp_path / "port" / "m.png")),
        cv2.imread(str(tmp_path / "jax" / "m.png"))[..., ::-1])
    # and the port reads its own file back as the JAX reader does
    got = pobj.load_obj(str(tmp_path / "port" / "m.obj"), load_texture=True)
    for ref in _both_jax(str(tmp_path / "jax" / "m.obj"), load_texture=True):
        _assert_same(got, ref)


def test_scan_prep_writes_the_jax_files(tmp_path):
    rng = np.random.default_rng(4)
    text = _mesh_text("v/vt", rng).replace("mtllib mesh.mtl\n", "").replace(
        "usemtl material_0\n", "")
    for tag, mod in (("port", pprep), ("jax", jprep)):
        d = tmp_path / tag / "scan"
        os.makedirs(d / "tex")
        open(d / "scan.obj", "w").write(text)
        mod.ensure_mtl(str(d / "scan.obj"))
        mod.ensure_mtl(str(d / "scan.obj"))     # a no-op the second time
        (d / "tex" / "scan_dif_2k.jpg").write_bytes(b"\xff\xd8\xff-texture")
        # copied with its longest extent as y, its MTL and texture along
        mod.copy_obj_y_up(str(d / "scan.obj"),
                          str(tmp_path / tag / "out" / "scan.obj"))
    for rel in ("scan/scan.obj", "scan/scan.mtl", "out/scan.obj",
                "out/scan.mtl", "out/tex/scan_dif_2k.jpg"):
        assert (open(tmp_path / "port" / rel, "rb").read()
                == open(tmp_path / "jax" / rel, "rb").read()), rel
    # a scan lying along x: rewritten with x as the up axis
    long = "".join("v %.6f %.6f %.6f\n" % tuple(p) for p in
                   rng.normal(size=(6, 3)) * [5.0, 1.0, 1.0]) + "f 1 2 3\n"
    for tag, mod in (("port", pprep), ("jax", jprep)):
        (tmp_path / tag / "long.obj").write_text(long)
        mod.copy_obj_y_up(str(tmp_path / tag / "long.obj"),
                          str(tmp_path / tag / "long_up.obj"))
    rotated = open(tmp_path / "port" / "long_up.obj").read()
    assert rotated == open(tmp_path / "jax" / "long_up.obj").read()
    assert rotated != long
