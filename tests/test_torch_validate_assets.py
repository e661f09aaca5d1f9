"""``python -m bodyfitting_torch.tools.validate_assets`` on the CPU: it
passes structurally valid synthetic assets, catches broken ones with the
JAX tool's rows and exit codes, and gives the JAX tool's rows on the same
files.

The files are those of ``tests/test_validate_assets.py`` (an SMPL-X
``.npz`` with 10,475 vertices, the GMM) and seeded checkpoints in the
released layouts (HMR, an OpenPose hand net, LBAM).  Rows compare by
status and name; a row's detail is compared where it is computed from the
file alone (counts, shapes), not from a forward pass, whose last digits
differ between the packages.
"""

import numpy as np
import pytest
import torch

from bodyfitting_tpu.tools import validate_assets as jva
from bodyfitting_torch.models import hmr as thmr
from bodyfitting_torch.models import inpaint as tlbam
from bodyfitting_torch.models import openpose as top
from bodyfitting_torch.tools import manifests as tmf
from bodyfitting_torch.tools import validate_assets as tva
from tests.test_validate_assets import _write_gmm, _write_smplx_npz

FORWARD_ROWS = ("zero-pose forward", "NLL(mean pose)", "hmr rotations",
                "lbam inpaints")


def _rows(mod, argv, device=None):
    rep = []
    orig = mod.Report.dump

    def keep(self):
        rep.extend(self.rows)
        orig(self)

    mod.Report.dump = keep
    try:
        rc = (mod.main(argv) if device is None
              else mod.main(argv, device=device))
    finally:
        mod.Report.dump = orig
    return rc, rep


def _assert_same_rows(a, b):
    assert [(ok, n) for ok, n, _ in a] == [(ok, n) for ok, n, _ in b]
    for (_, n, da), (_, _, db) in zip(a, b):
        if not n.startswith(FORWARD_ROWS):
            assert da == db, (n, da, db)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    d = tmp_path_factory.mktemp("assets")
    out = dict(npz=d / "SMPLX_NEUTRAL.npz", broken=d / "SMPLX_BROKEN.npz",
               gmm=d / "gmm_08.pkl", gmm5=d / "gmm_05.pkl",
               hmr=d / "model_checkpoint.pt", hand=d / "hand_pose_model.pth",
               hand_bad=d / "hand_bad.pth", lbam=d / "lbam.pth",
               lbam_bad=d / "lbam_bad.pth")
    _write_smplx_npz(out["npz"])
    _write_smplx_npz(out["broken"], break_weights=True)
    _write_gmm(out["gmm"])
    _write_gmm(out["gmm5"], K=5)
    torch.save({"model": thmr.seeded_state_dict(0)}, str(out["hmr"]))
    hand = top.seeded_state_dict("hand", 0)
    torch.save(hand, str(out["hand"]))
    bad = dict(hand)
    del bad["Mconv3_stage4.weight"]
    bad["conv1_1.weight"] = torch.zeros(64, 3, 5, 5)
    torch.save(bad, str(out["hand_bad"]))
    lb = {k: torch.from_numpy(v) for k, v in
          tlbam.seeded_state_dict(0).items()}
    torch.save(lb, str(out["lbam"]))
    del lb["ec1.conv.conv.weight"]
    torch.save(lb, str(out["lbam_bad"]))
    return {k: str(v) for k, v in out.items()}


def test_good_assets_pass(assets, capsys):
    rc = tva.main(["--model_path", assets["npz"], "--model_type", "smplx",
                   "--gmm", assets["gmm"]], device="cpu")
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "0 failure(s)" in out
    assert "PASS  zero-pose forward == v_template" in out


def test_broken_weights_fail(assets, capsys):
    rc = tva.main(["--model_path", assets["broken"], "--model_type",
                   "smplx"], device="cpu")
    out = capsys.readouterr().out
    assert rc == 1, out
    assert "FAIL  lbs weight rows sum to 1" in out


def test_wrong_gmm_fails(assets, capsys):
    rc = tva.main(["--gmm", assets["gmm5"]], device="cpu")
    out = capsys.readouterr().out
    assert rc == 1, out
    assert "FAIL  8 mixture components" in out


def test_no_asset_is_an_argument_error():
    with pytest.raises(SystemExit) as e:
        tva.main([], device="cpu")
    assert e.value.code == 2


def test_broken_checkpoints_fail_key_by_key(assets, capsys):
    rc = tva.main(["--openpose_hand", assets["hand_bad"], "--lbam",
                   assets["lbam_bad"]], device="cpu")
    out = capsys.readouterr().out
    assert rc == 1, out
    assert "FAIL  openpose hand: all 104 required tensors present" in out
    assert "Mconv3_stage4.weight" in out
    assert "FAIL  openpose hand: tensor shapes match" in out
    assert "FAIL  lbam: all" in out and "ec1.conv.conv.weight" in out


@pytest.mark.parametrize("which", ["model", "checkpoints", "broken"])
def test_both_tools_give_the_same_rows(assets, which):
    argv = {
        "model": ["--model_path", assets["npz"], "--model_type", "smplx",
                  "--gmm", assets["gmm"]],
        "checkpoints": ["--hmr", assets["hmr"], "--openpose_hand",
                        assets["hand"], "--lbam", assets["lbam"]],
        "broken": ["--model_path", assets["broken"], "--gmm",
                   assets["gmm5"], "--openpose_hand", assets["hand_bad"],
                   "--lbam", assets["lbam_bad"]],
    }[which]
    rc_t, rows_t = _rows(tva, argv, device="cpu")
    rc_j, rows_j = _rows(jva, argv)
    assert rc_t == rc_j == (1 if which == "broken" else 0)
    _assert_same_rows(rows_t, rows_j)


class _Opaque:
    """A pickled object that ``weights_only=True`` refuses."""


def test_unsafe_load_is_opt_in(tmp_path, capsys):
    path = str(tmp_path / "pickled.pt")
    torch.save({"model": _Opaque()}, path)
    rc = tva.main(["--hmr", path], device="cpu")
    out = capsys.readouterr().out
    assert rc == 1 and "FAIL  hmr loads with weights_only=True" in out
    rc = tva.main(["--hmr", path, "--unsafe-load"], device="cpu")
    out = capsys.readouterr().out
    assert "weights_only load failed, using --unsafe-load" in out


def test_manifests_match_the_networks():
    req, opt = tmf.expected_hmr_state_dict(thmr.HMR())
    assert "fc1.weight" in req and "init_pose" in opt
    assert all(k.endswith("num_batches_tracked") or k.startswith("init_")
               for k in opt)
    for kind in ("body", "hand", "face"):
        req, opt = tmf.expected_openpose_state_dict(top.net_structure(kind))
        assert opt == {} and set(req) == set(top.seeded_state_dict(kind))
    req, _ = tmf.expected_lbam_state_dict(tlbam.LBAM())
    assert set(req) == set(tlbam.seeded_state_dict(0))
    report = tmf.check_state_dict({"x": np.zeros(3)}, {"x": (3,), "y": (2,)},
                                  {"z": (1,)})
    assert not report["ok"] and report["missing"] == {"y": (2,)}


def test_tool_needs_a_gpu_unless_asked_for_cpu(assets, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tva.main(["--gmm", assets["gmm"]])
