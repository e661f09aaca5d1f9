"""The work counts at the two cells' shapes, and what the benchmark's run
may import: no module whose top-level name is ``jax``, ``jaxlib``,
``flax`` or ``bodyfitting_tpu`` (names compared whole, so
``bodyfitting_torch`` passes), and nothing of the program in the plain
reference."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest

from benchmark import counts, harness

ROOT = harness.ROOT


def _config(name):
    return harness.load_json(harness.HERE, "configs", name + ".json")


def test_mask_cell_counts():
    cfg = _config("smplx_genebody")
    ops, nbytes = counts.silhouette(cfg, 8)
    # 64 views x (the match 7 x 512 x 2,619, the sample 33 x 2,619, the
    # lookup 17 x 512, the scatter 2 x 512)
    assert ops == 64 * (7 * 512 * 2619 + 33 * 2619 + 17 * 512 + 2 * 512)
    t, by = counts.bound_s(nbytes, ops)
    assert by == "operations" and 9.0e-6 < t < 9.1e-6
    pre, post = counts.mask_step_ops(cfg, 8)
    assert 0 < pre < post and post - pre > 3 * ops
    n = cfg["fit"]["num_iters"]
    assert counts.mask_fit_ops(cfg, 8) == 201 * pre + (n - 201) * post
    assert counts.mask_rows(cfg) == 2619 + 21 + 204


def test_keypoint_cell_counts():
    """Without masks: the joints-reduced rows, no silhouette work, a step
    alike on both sides of the gate."""
    cfg = harness.cell("genebody_kp_b8")["config"]
    assert counts.mask_rows(cfg) == 21 + 204
    pre, post = counts.mask_step_ops(cfg, 8)
    assert 0 < pre == post < counts.mask_step_ops(_config("smplx_genebody"),
                                                  8)[0]
    assert counts.mask_fit_ops(cfg, 8) == 600 * pre


@pytest.mark.parametrize("den", [2, 3, 4])
def test_counts_follow_the_configuration(den):
    """The gate, the keypoints and the vertex-picked rows come from the
    configuration's file, not from the counting code."""
    cfg = _config("smplx_genebody")
    cfg["fit"]["stage_gate_den"] = den
    gate = 600 // den
    pre, post = counts.mask_step_ops(cfg, 8)
    assert counts.gate_step(cfg) == gate
    assert counts.mask_fit_ops(cfg, 8) == (gate + 1) * pre \
        + (599 - gate) * post
    more = dict(cfg, rig=dict(cfg["rig"], keypoints=136),
                model=dict(cfg["model"], vertex_joints=22))
    assert counts.mask_rows(more) == counts.mask_rows(cfg) + 1
    assert counts.mask_step_ops(more, 8)[0] > pre
    scan = _config("smpl_renderpeople")
    scan["fit"]["stage_gate_den"] = den
    pre, post, disp = counts.scan_step_ops(scan)
    assert counts.scan_fit_ops(scan) == (gate + 1) * pre \
        + (599 - gate) * post + 600 * disp


def test_scan_cell_counts():
    cfg = _config("smpl_renderpeople")
    pre, post, disp = counts.scan_step_ops(cfg)
    assert 0 < pre < disp < post
    assert counts.scan_fit_ops(cfg) == 201 * pre + 399 * post + 600 * disp
    nbytes = counts.volume_bytes(cfg)
    assert nbytes == 96 ** 3 * 20 + 220416 * 36 + 110210 * 12
    assert counts.bound_s(nbytes, 0.0)[1] == "bytes"


def test_peaks_and_power_limit():
    assert counts.F32_FLOPS_PER_S == 67e12
    assert counts.HBM_BYTES_PER_S == 3.35e12
    assert isinstance(counts.power_limit(), str)


def test_forbidden_names_are_whole():
    before = dict(sys.modules)
    try:
        sys.modules["bodyfitting_torch_x"] = sys
        sys.modules["jaxlike"] = sys
        assert harness.forbidden_modules() == sorted(
            {m.split(".")[0] for m in before} & set(harness.FORBIDDEN))
        sys.modules["bodyfitting_tpu.io"] = sys
        assert "bodyfitting_tpu" in harness.forbidden_modules()
    finally:
        for k in ("bodyfitting_torch_x", "jaxlike", "bodyfitting_tpu.io"):
            sys.modules.pop(k, None)


RUN_SMALL = r"""
import json, os, sys
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
from small import small_tree
root = small_tree({tmp!r})
from benchmark import harness, run
rc = run.main(["--workload", {cell!r}, "--seed", "4294967311", "--seconds",
               "0", "--trace", "0"], device="cpu", root=root)
print(json.dumps(dict(rc=rc, forbidden=harness.forbidden_modules(),
                      program=sorted(m for m in sys.modules
                                     if m.startswith("bodyfitting_torch")))))
"""


@pytest.mark.parametrize("cell", ["genebody_mask_b8", "rp_scan_sdf"])
def test_a_run_imports_no_jax(tmp_path, cell):
    """A whole run of the cell, on the CPU at a small size, in a fresh
    process: the program is loaded, and nothing of JAX."""
    code = RUN_SMALL.format(root=ROOT, tests=os.path.dirname(__file__),
                            tmp=str(tmp_path / "bench"), cell=cell)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["rc"] == 0 and res["forbidden"] == []
    assert "bodyfitting_torch.fitting.smplify" in res["program"]


def test_reference_imports_nothing_of_the_program():
    ref_dir = os.path.join(harness.HERE, "reference")
    for name in sorted(os.listdir(ref_dir)):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(ref_dir, name)).read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom)
                    else [])
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("bodyfitting_torch",) + harness.FORBIDDEN, \
                    (name, m)
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.reference.body, benchmark.reference.losses, "
            "benchmark.reference.observations, benchmark.reference.volume; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    tops = set(json.loads(out.stdout.replace("'", '"')))
    assert not tops & {"bodyfitting_torch", *harness.FORBIDDEN}
