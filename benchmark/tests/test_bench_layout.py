"""The harness is driven by data: a configuration, a cell and a per-layer
metric added as new files and entries are listed, loaded and run with no
edit to a file that was there; a cell's files are found by its name; and
a measuring run on a machine without a card exits non-zero with no
result, where it could have fallen back to the CPU."""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

from benchmark import harness, run
from benchmark.tests.small import small_tree

METRIC = '''"""Units fitted in the window."""


def read(run):
    return float(len(run["records"]))
'''


def _hashes(top):
    out = {}
    for d, _, files in os.walk(top):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, top)] = hashlib.sha1(
                        fh.read()).hexdigest()
    return out


def _add(tmp):
    """A configuration, a cell and a metric, as new files and entries."""
    root = small_tree(str(tmp))
    before = _hashes(root)
    cfg = harness.load_json(root, "configs", "smplx_genebody.json")
    cfg["rig"]["mask_views"] = 4
    with open(os.path.join(root, "configs", "smplx_four_masks.json"),
              "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "workloads", "genebody_four_masks.json"),
              "w") as f:
        json.dump(dict(config="smplx_four_masks", driver="mask_fit",
                       traffic=harness.load_json(
                           root, "workloads",
                           "genebody_mask_b8.json")["traffic"]), f)
    with open(os.path.join(root, "metrics", "units_in_window.py"), "w") as f:
        f.write(METRIC)
    bench_path = os.path.join(str(tmp), "BENCHMARK.json")
    bench = harness.load_json(bench_path)
    bench["configs"].append(dict(
        bench["configs"][0], name="smplx_four_masks",
        file="benchmark/configs/smplx_four_masks.json"))
    bench["workloads"].append(dict(bench["workloads"][0],
                                   name="genebody_four_masks",
                                   config="smplx_four_masks",
                                   traffic="genebody_four_masks"))
    for m in bench["end_to_end"]:
        if m["name"] == "fit_frames_per_s":
            m["workloads"].append("genebody_four_masks")
    bench["per_layer"].append(dict(
        name="units_in_window", unit="units", better="higher",
        source="host_clock", layer="optimizer", moves="fit_frames_per_s",
        workloads=["genebody_four_masks"]))
    with open(bench_path, "w") as f:
        json.dump(bench, f)
    return root, before


def test_new_files_are_found_by_name(tmp_path):
    root, before = _add(tmp_path)
    new = harness.cell("genebody_four_masks", root=root)
    assert new["config"]["rig"]["mask_views"] == 4
    assert new["driver"].__file__ == os.path.join(root, "drivers",
                                                  "mask_fit.py")
    assert [m["name"] for m in new["per_layer"]] == ["units_in_window"]
    assert {m["name"] for m in new["end_to_end"]} == {"fit_frames_per_s",
                                                      "setup_s"}
    old = harness.cell("genebody_mask_b8", root=root)
    assert "units_in_window" not in {m["name"] for m in old["per_layer"]}
    after = _hashes(root)
    assert {k: after[k] for k in before} == before


def test_new_cell_runs_with_no_edit(tmp_path, capsys):
    root, before = _add(tmp_path)
    rc = run.main(["--workload", "genebody_four_masks", "--seed", "21",
                   "--seconds", "0", "--trace", "1"], device="cpu", root=root)
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["metrics"] == {"units_in_window": {"value": 1.0,
                                                  "unit": "units"}}
    assert set(res["checks"]) == {"obs", "verts", "steps", "gate_loss",
                                  "gate_grad"}
    after = _hashes(root)
    assert {k: after[k] for k in before} == before


def test_keypoint_cell_is_found_and_run(tmp_path, capsys):
    """The keypoint-only cell: the configuration of the mask cell with the
    workload's ``use_mask`` false over it, no masks in its pool, no masked
    step to check, and its per-layer metrics read."""
    root = small_tree(str(tmp_path))
    kp = harness.cell("genebody_kp_b8", root=root)
    assert kp["config"]["fit"]["use_mask"] is False
    assert harness.cell("genebody_mask_b8",
                        root=root)["config"]["fit"]["use_mask"] is True
    names = {m["name"] for m in kp["per_layer"]}
    assert "silhouette_roofline_pct" not in names
    assert "obs_contours_ms.fit" not in names
    for trace in ("0", "1"):
        rc = run.main(["--workload", "genebody_kp_b8", "--seed", "4294967311",
                       "--seconds", "0", "--trace", trace], device="cpu",
                      root=root)
        assert rc == 0
        res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert res["correct"] is True, res["checks"]
        assert set(res["checks"]) == {"obs", "verts", "steps"}
        want = kp["per_layer"] if trace == "1" else kp["end_to_end"]
        # the device-trace readers find no device events on the CPU
        assert set(res["metrics"]) <= {m["name"] for m in want}
        assert ("fit_frames_per_s" in res["metrics"]) is (trace == "0")


def test_split_metric_falls_back_to_its_base_reader(tmp_path):
    """``<name>.<part>`` with no file of its own is read by
    ``<name>.py``; a file of its own comes first."""
    root = small_tree(str(tmp_path))
    for name in ("step_ms.fit", "step_ms.scan", "device_idle_pct.scan"):
        mod = harness.load_module("metrics", name, root)
        assert mod.__file__ == os.path.join(
            root, "metrics", name.split(".")[0] + ".py")
    with open(os.path.join(root, "metrics", "step_ms.scan.py"), "w") as f:
        f.write(METRIC)
    assert harness.load_module("metrics", "step_ms.scan", root).__file__ \
        == os.path.join(root, "metrics", "step_ms.scan.py")
    for m in harness.load_json(tmp_path / "BENCHMARK.json")["per_layer"]:
        assert hasattr(harness.load_module("metrics", m["name"], root),
                       "read"), m["name"]


def test_no_card_no_result(tmp_path):
    """From a checkout that holds only ``BENCHMARK.json`` and the
    benchmark's files, on a machine that shows no card."""
    small_tree(str(tmp_path))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "rp_scan_sdf",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no result" in out.stderr
