"""The control on the card: the program with its TF32 path on (float32
computed in the nearest precision below the configuration's) fails one
of a cell's compared numbers where the sound program passes them all.
At a small size here; ``python3 -m benchmark.tests.faults`` reads the
control and the faults at the cells' own sizes."""

from __future__ import annotations

import pytest

from benchmark.tests import faults
from benchmark.tests.small import small_tree


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["genebody_mask_b8", "rp_scan_sdf"])
def test_control_fails_where_sound_passes(tmp_path, cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is the program's TF32 "
                    "path")
    from benchmark import harness

    root = small_tree(str(tmp_path))
    limits = harness.cell(cell, root=root)["driver"].LIMITS
    res = faults.readings(cell, [12345], ("sound", "control"), root=root)
    sound, control = res["sound"][0], res["control"][0]
    assert all(sound[k] <= limits[k] for k in limits), sound
    assert any(control[k] > limits[k] for k in limits), control
