"""RenderPeople scan preparation (the reference's ``utils/io_utils.py``
``mtl_check`` and ``copy_obj``).

Counterpart of ``bodyfitting_tpu/io/scan_prep.py``: RenderPeople OBJs
sometimes lack their MTL reference and may be exported with another axis
up; these helpers normalise both before the pipeline runs (the app's
``--prep_scans``).  The files they write equal the JAX helpers' byte for
byte.
"""

from __future__ import annotations

import os
import shutil

import numpy as np


def ensure_mtl(obj_path: str, tex_relpath: str | None = None) -> None:
    """Insert ``mtllib`` / ``usemtl`` lines before the first face and
    write a default MTL naming ``tex_relpath`` (default
    ``tex/<subject>_dif_2k.jpg``), unless the OBJ already uses a
    material."""
    base = os.path.dirname(obj_path)
    subject = os.path.splitext(os.path.basename(obj_path))[0]
    with open(obj_path) as f:
        lines = f.readlines()
    if any(ln.startswith("usemtl") for ln in lines):
        return
    first_face = next(
        (i for i, ln in enumerate(lines) if ln.startswith("f ")), len(lines))
    lines[first_face:first_face] = [f"mtllib {subject}.mtl\n",
                                    "usemtl default\n"]
    with open(obj_path, "w") as f:
        f.writelines(lines)
    tex = tex_relpath or f"tex/{subject}_dif_2k.jpg"
    with open(os.path.join(base, subject + ".mtl"), "w") as f:
        f.write("newmtl default\nKa 0 0 0\nKd 0.588 0.588 0.588\n"
                "Ks 0 0 0\nKe 0 0 0\nTf 1 1 1\nillum 0\nNs 2\n"
                f"map_Kd {tex}\n")


def copy_obj_y_up(obj_path: str, target_path: str) -> None:
    """Copy a scan, rotated so that its longest extent is the Y axis
    (``new_y = old_up``, ``new_up = -old_y``), with its MTL and textures
    copied alongside."""
    verts = []
    mtlfile = None
    with open(obj_path) as f:
        lines = f.readlines()
    for ln in lines:
        if ln.startswith("mtllib"):
            mtlfile = ln.split()[1]
        elif ln.startswith("v "):
            verts.append([float(v) for v in ln.split()[1:4]])
    verts = np.asarray(verts)
    up_axis = int((verts.max(0) - verts.min(0)).argmax())

    os.makedirs(os.path.dirname(target_path) or ".", exist_ok=True)
    if up_axis == 1:
        shutil.copy(obj_path, target_path)
    else:
        with open(target_path, "w") as out:
            for ln in lines:
                if ln.startswith("v "):
                    v = [float(x) for x in ln.split()[1:4]]
                    new_v = list(v)
                    new_v[1] = v[up_axis]
                    new_v[up_axis] = -v[1]
                    out.write(f"v {new_v[0]} {new_v[1]} {new_v[2]}\n")
                else:
                    out.write(ln)

    if mtlfile is None:
        return
    base = os.path.dirname(obj_path)
    target_base = os.path.dirname(target_path)
    mtl_src = os.path.join(base, mtlfile)
    if not os.path.exists(mtl_src):
        return
    shutil.copy(mtl_src, os.path.join(target_base, mtlfile))
    with open(mtl_src) as f:
        for ln in f:
            if "map_Kd" in ln.split():
                tex = ln.split()[-1]
                src = os.path.join(base, tex)
                dst = os.path.join(target_base, tex)
                if os.path.exists(src):
                    os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
                    shutil.copy(src, dst)
