"""Whole runs on the CPU at a small size (the look for a card skipped)
with the timed path broken underneath: ``correct`` comes out false for
each fault a fit cell can have, and true for the sound program and its
sound alternative routes."""

from __future__ import annotations

import json

import pytest

from benchmark import run
from benchmark.tests import faults
from benchmark.tests.small import small_tree

CASES = [(cell, v) for cell in ("genebody_mask_b8", "rp_scan_sdf",
                                 "genebody_kp_b8")
         for v in ("sound", "state_unchanged", "half_batch", "answer_altered")
         ] + [("genebody_mask_b8", v) for v in ("mask_half",)
              + faults.SOUND_ROUTES]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return small_tree(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_makes_run_incorrect(tree, capsys, cell, fault):
    with faults.variant(fault, scan=cell == "rp_scan_sdf"):
        rc = run.main(["--workload", cell, "--seed", "8589934597",
                       "--seconds", "0", "--trace", "0"], device="cpu",
                      root=tree)
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    sound = fault in ("sound",) + faults.SOUND_ROUTES
    assert res["correct"] is sound, res["checks"]
