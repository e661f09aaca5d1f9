"""A copy of the benchmark's tree whose cells are cut to a size the
CPU runs in seconds (4 views at 128 px, 9 steps, a 12^3 volume), for
tests that drive whole runs on the CPU."""

from __future__ import annotations

import json
import os
import shutil

from benchmark import harness


def _edit(path, fn):
    with open(path) as f:
        d = json.load(f)
    fn(d)
    with open(path, "w") as f:
        json.dump(d, f, indent=1)


def small_tree(dst):
    """``dst/benchmark`` (returned) and ``dst/BENCHMARK.json``."""
    root = os.path.join(dst, "benchmark")
    shutil.copytree(harness.HERE, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), dst)

    def mask(d):
        d["rig"].update(views=4, imsize=128, focal=225.0, mask_views=2,
                        contour_points=64)
        d["fit"].update(imsize=128.0, num_iters=9)

    def scan(d):
        d["rig"].update(views=4, imsize=128)
        d["fit"].update(imsize=128.0, num_iters=9, sdf_resolution=12)
        d["scan"].update(num_verts=6890, num_faces=13776, subdivisions=0)

    _edit(os.path.join(root, "configs", "smplx_genebody.json"), mask)
    _edit(os.path.join(root, "configs", "smpl_renderpeople.json"), scan)
    for cell in ("genebody_mask_b8", "genebody_kp_b8"):
        _edit(os.path.join(root, "workloads", cell + ".json"),
              lambda d: d["traffic"].update(frames_per_unit=2, pool_units=2,
                                            splat_dilate=1))
    _edit(os.path.join(root, "workloads", "rp_scan_sdf.json"),
          lambda d: d["traffic"].update(pool_units=1, subdivisions=0))
    return root
