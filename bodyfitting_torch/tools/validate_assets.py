"""Validate real (licensed) assets against the port's loaders.

The tests run on synthetic files: the licensed SMPL/SMPL-X models,
``gmm_08.pkl`` and the HMR, OpenPose and LBAM checkpoints are not in the
repository.  This tool loads the real files through the port's own
loaders on the card and checks what the fits rely on, printing a
PASS/FAIL report: the counterpart of ``bodyfitting_tpu/tools/
validate_assets.py``, with the same rows and exit codes.

Usage::

    python -m bodyfitting_torch.tools.validate_assets \\
        --model_path data/smplx/SMPLX_NEUTRAL.npz \\
        [--model_type smplx] [--gmm data/gmm_08.pkl] \\
        [--hmr data/model_checkpoint.pt] \\
        [--openpose_body body_pose_model.pth] \\
        [--openpose_hand hand_pose_model.pth] \\
        [--openpose_face face_pose_model.pth] \\
        [--lbam LBAM_NoBN_ParisStreetView.pth]

Checkpoints are first checked against their key and shape manifests
(``tools/manifests.py``), so a wrong or truncated file is reported key by
key before anything is loaded.  The checks run on the card; ``main(argv,
device="cpu")`` runs them on the CPU (without a card, and without that,
``main`` raises).

Exit status 0 iff every requested check passes.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from bodyfitting_torch.device import default_device


class Report:
    """The report's rows: ``(ok, name, detail)``, ``ok`` None for an
    information row."""

    def __init__(self):
        self.rows = []
        self.failed = 0

    def check(self, name, ok, detail=""):
        self.rows.append((bool(ok), name, detail))
        if not ok:
            self.failed += 1

    def info(self, name, detail):
        self.rows.append((None, name, detail))

    def dump(self):
        for ok, name, detail in self.rows:
            tag = "  ...." if ok is None else ("  PASS" if ok else "* FAIL")
            line = f"{tag}  {name}"
            if detail:
                line += f"  [{detail}]"
            print(line)
        print(f"\n{self.failed} failure(s), "
              f"{sum(1 for r in self.rows if r[0] is True)} passed.")


def _np(t):
    return t.detach().cpu().numpy()


def validate_model(path: str, model_type, rep: Report, device):
    """Body-model invariants: skinning weights and joint regressor rows,
    faces, the published vertex count, a zero-pose forward equal to the
    template, the SMPL-X tables, a finite posed forward."""
    from bodyfitting_torch.models import body_model as bm

    model = bm.load_model(path, model_type=model_type, flat_hand_mean=True,
                          device=device)
    V = model.v_template.shape[0]
    J = model.J_regressor.shape[0]
    rep.info("model", f"type={model.model_type} V={V} J={J} "
                      f"F={model.faces.shape[0]}")

    w = _np(model.lbs_weights)
    rep.check("lbs weight rows sum to 1",
              np.allclose(w.sum(1), 1.0, atol=1e-4),
              f"max |sum-1| = {np.abs(w.sum(1) - 1).max():.2e}")
    rep.check("lbs weights non-negative", (w >= -1e-6).all())

    jr = _np(model.J_regressor)
    rep.check("J_regressor rows sum to 1",
              np.allclose(jr.sum(1), 1.0, atol=1e-3),
              f"max |sum-1| = {np.abs(jr.sum(1) - 1).max():.2e}")

    f = _np(model.faces)
    rep.check("face indices in range", f.min() >= 0 and f.max() < V)
    degen = (f[:, 0] == f[:, 1]) | (f[:, 1] == f[:, 2]) | (f[:, 0] == f[:, 2])
    rep.check("no duplicate-vertex faces", not degen.any(),
              f"{int(degen.sum())} degenerate")

    expected_v = {"smpl": 6890, "smplh": 6890, "smplx": 10475}
    rep.check(f"vertex count matches published {model.model_type}",
              V == expected_v.get(model.model_type, V),
              f"{V} vs {expected_v.get(model.model_type)}")

    with torch.no_grad():
        out = bm.forward(model, bm.BodyParams.zeros(model))
    dv = np.abs(_np(out.vertices[0]) - _np(model.v_template))
    rep.check("zero-pose forward == v_template",
              dv.max() < 1e-4, f"max |dv| = {dv.max():.2e}")

    if model.model_type == "smplx":
        rep.check(
            "expression dirs present (shapedirs 300:310 slice)",
            model.expr_dirs is not None
            and model.expr_dirs.shape[0] == model.num_expressions,
            f"{None if model.expr_dirs is None else tuple(model.expr_dirs.shape)}",
        )
        rep.check("static landmark table is 51 faces",
                  model.lmk_faces_idx is not None
                  and model.lmk_faces_idx.shape[0] == 51)
        rep.check("dynamic landmark table is [79, 17]",
                  model.dyn_lmk_faces_idx is not None
                  and tuple(model.dyn_lmk_faces_idx.shape) == (79, 17))
        lf = _np(model.lmk_faces_idx)
        rep.check("landmark face ids in range",
                  lf.min() >= 0 and lf.max() < model.faces.shape[0])
    if model.model_type in ("smplh", "smplx"):
        hc = model.hand_components_l
        rep.check("hand PCA components are [<=45, 45]",
                  hc is not None and hc.shape[1] == 45,
                  f"{None if hc is None else tuple(hc.shape)}")
        rep.check("hand means are 45-dim",
                  model.hand_mean_l is not None
                  and model.hand_mean_l.shape[-1] == 45)

    # a posed forward is finite at a generic pose
    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), dtype=model.dtype,
                               device=model.device)[None]

    p = dataclasses.replace(
        bm.BodyParams.zeros(model),
        body_pose=t(rng.normal(scale=0.2, size=3 * model.num_body_joints)),
        betas=t(rng.normal(size=model.num_betas)))
    with torch.no_grad():
        out = bm.forward(model, p)
    rep.check("posed forward finite",
              bool(torch.isfinite(out.vertices).all())
              and bool(torch.isfinite(out.joints).all()))
    return model


def validate_gmm(path: str, rep: Report, device):
    """``gmm_08.pkl`` invariants: 8 components over the 69-dim SMPL body
    pose, positive-definite precisions, finite weights, and the mean pose
    preferred over a wild one."""
    from bodyfitting_torch.losses.priors import load_gmm_prior

    prior = load_gmm_prior(path, device=device)
    K, D = prior.means.shape
    rep.info("gmm", f"K={K} D={D}")
    rep.check("8 mixture components (gmm_08)", K == 8)
    rep.check("69-dim SMPL body pose", D == 69)
    eig = np.linalg.eigvalsh(_np(prior.precisions))
    rep.check("precision matrices positive-definite",
              (eig > 0).all(), f"min eig = {eig.min():.2e}")
    rep.check("nll weights finite",
              bool(torch.isfinite(prior.log_nll_weights).all()))
    with torch.no_grad():
        nll_mean = float(prior(prior.means[0]))
        wild = np.random.default_rng(0).normal(scale=2.0, size=D)
        nll_wild = float(prior(torch.as_tensor(wild, dtype=torch.float32,
                                               device=prior.means.device)))
    rep.check("NLL(mean pose) < NLL(wild pose)", nll_mean < nll_wild,
              f"{nll_mean:.1f} vs {nll_wild:.1f}")


def _structural_check(rep, name, state_dict, required, optional):
    """Manifest rows: required tensors present, shapes, extra keys."""
    from bodyfitting_torch.tools.manifests import check_state_dict

    r = check_state_dict(state_dict, required, optional)
    rep.check(
        f"{name}: all {r['n_required']} required tensors present",
        not r["missing"],
        "" if not r["missing"] else
        f"{len(r['missing'])} missing, e.g. {list(r['missing'])[:3]}",
    )
    rep.check(
        f"{name}: tensor shapes match the published architecture",
        not r["mismatched"],
        "" if not r["mismatched"] else
        f"{len(r['mismatched'])} wrong, e.g. "
        + str({k: v for k, v in list(r['mismatched'].items())[:2]}),
    )
    if r["extra"]:
        rep.info(f"{name}: extra keys ignored",
                 f"{len(r['extra'])}, e.g. {r['extra'][:3]}")
    return r["ok"]


def _torch_load_checkpoint(path: str, rep: Report, name: str,
                           unsafe_load: bool):
    """``torch.load(weights_only=True)``: the three checkpoint families are
    plain tensor dicts.  ``weights_only=False`` runs pickled code from the
    very file being vetted, so it is tried only with ``--unsafe-load``."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:  # noqa: BLE001 (pickle errors vary widely)
        if unsafe_load:
            rep.info(f"{name}: weights_only load failed, using "
                     f"--unsafe-load pickle fallback", str(e)[:100])
            return torch.load(path, map_location="cpu", weights_only=False)
        rep.check(
            f"{name} loads with weights_only=True", False,
            f"{str(e)[:100]} — re-run with --unsafe-load ONLY if you "
            f"trust this file (executes pickled code)",
        )
        return None


def validate_hmr(path: str, rep: Report, device, unsafe_load=False):
    """HMR checkpoint: the manifest check, the load, a forward."""
    from bodyfitting_torch.models import hmr as hmr_mod
    from bodyfitting_torch.tools.manifests import expected_hmr_state_dict

    net = hmr_mod.HMR()
    ckpt = _torch_load_checkpoint(path, rep, "hmr", unsafe_load)
    if ckpt is None:
        return
    sd = ckpt["model"] if isinstance(ckpt, dict) and isinstance(
        ckpt.get("model"), dict) else ckpt
    required, optional = expected_hmr_state_dict(net)
    if not _structural_check(rep, "hmr", sd, required, optional):
        return
    try:
        hmr_mod.load_state_dict_checked(net, sd)
        rep.check("hmr checkpoint converts", True)
    except Exception as e:  # noqa: BLE001
        rep.check("hmr checkpoint converts", False, str(e)[:120])
        return
    n_params = sum(p.numel() for p in net.parameters())
    n_params += sum(b.numel() for n, b in net.named_buffers()
                    if not n.endswith("num_batches_tracked"))
    rep.info("hmr", f"{n_params / 1e6:.1f}M parameters")
    net = net.to(device)
    rot = _np(hmr_mod.hmr_forward(
        net, torch.zeros((1, 224, 224, 3), device=device))[0])
    rep.check("hmr output is 24 rotation matrices",
              rot.shape[-3:] == (24, 3, 3))
    rtr = rot.reshape(-1, 3, 3)
    orth = np.abs(rtr @ rtr.transpose(0, 2, 1) - np.eye(3)).max()
    rep.check("hmr rotations orthonormal", orth < 1e-3,
              f"max |RR^T - I| = {orth:.2e}")


def validate_openpose(path: str, which: str, rep: Report, device,
                      unsafe_load=False):
    """OpenPose ``.pth``: the manifest check, the load, a 368² forward."""
    from bodyfitting_torch.models import openpose as op
    from bodyfitting_torch.tools.manifests import (
        expected_openpose_state_dict,
        normalize_openpose_keys,
    )

    sd = _torch_load_checkpoint(path, rep, f"openpose {which}", unsafe_load)
    if sd is None:
        return
    required, optional = expected_openpose_state_dict(op.net_structure(which))
    if not _structural_check(rep, f"openpose {which}",
                             normalize_openpose_keys(sd), required, optional):
        return
    try:
        net = op.net_from_state_dict(which, sd, device, f"openpose {which}")
        rep.check(f"openpose {which} net converts", True)
    except Exception as e:  # noqa: BLE001
        rep.check(f"openpose {which} net converts", False, str(e)[:120])
        return
    with torch.no_grad():
        out = net(torch.zeros((1, 3, 368, 368), device=device))
    if not isinstance(out, (tuple, list)):
        out = (out,)
    # reported channels last, as the JAX tool reports its NHWC maps
    shapes = tuple(tuple(o.permute(0, 2, 3, 1).shape) for o in out)
    n_ch = {"body": (38, 19), "hand": (22,), "face": (71,)}[which]
    rep.check(f"openpose {which} output channels {n_ch}",
              tuple(s[-1] for s in shapes) == n_ch, f"{shapes}")


def validate_lbam(path: str, rep: Report, device, unsafe_load=False):
    """LBAM ``.pth``: the manifest check, the load, a finite inpainting."""
    from bodyfitting_torch.models import inpaint as lbam
    from bodyfitting_torch.tools.manifests import expected_lbam_state_dict

    sd = _torch_load_checkpoint(path, rep, "lbam", unsafe_load)
    if sd is None:
        return
    required, optional = expected_lbam_state_dict(lbam.LBAM())
    if not _structural_check(rep, "lbam", sd, required, optional):
        return
    try:
        inp = lbam.Inpainter(state_dict=sd, device=device)
        rep.check("lbam checkpoint converts", True)
    except Exception as e:  # noqa: BLE001
        rep.check("lbam checkpoint converts", False, str(e)[:120])
        return
    img = np.full((64, 64, 3), 128, np.uint8)
    mask = np.zeros((64, 64, 3), np.uint8)
    mask[16:48, 16:48] = 255
    out = inp(img, mask)
    rep.check("lbam inpaints finite values in [0,1]",
              np.isfinite(out).all() and out.min() >= 0
              and out.max() <= 1.0)


def config_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model_path", help="SMPL .pkl / SMPL-X .npz asset")
    ap.add_argument("--model_type", default=None,
                    choices=[None, "smpl", "smplh", "smplx"])
    ap.add_argument("--gmm", help="gmm_08.pkl pose prior")
    ap.add_argument("--hmr", help="HMR model_checkpoint.pt")
    ap.add_argument("--openpose_body", help="body_pose_model.pth")
    ap.add_argument("--openpose_hand", help="hand_pose_model.pth")
    ap.add_argument("--openpose_face", help="face net .pth")
    ap.add_argument("--lbam", help="LBAM_NoBN_ParisStreetView.pth")
    ap.add_argument(
        "--unsafe-load", action="store_true",
        help="fall back to torch.load(weights_only=False) when the safe "
             "loader rejects a checkpoint — executes pickled code from "
             "the file; use only on files you trust")
    return ap


def main(argv=None, device=None) -> int:
    """Run the requested checks on ``device`` (default ``cuda``; raises
    without a card), print the report, and return the exit status: 0
    iff every check passed.  No asset at all is an argument error."""
    ap = config_parser()
    args = ap.parse_args(argv)
    if not any(getattr(args, k) for k in (
            "model_path", "gmm", "hmr", "openpose_body", "openpose_hand",
            "openpose_face", "lbam")):
        ap.error("give at least one asset to validate")
    device = default_device(device)
    unsafe = args.unsafe_load
    rep = Report()
    if args.model_path:
        validate_model(args.model_path, args.model_type, rep, device)
    if args.gmm:
        validate_gmm(args.gmm, rep, device)
    if args.hmr:
        validate_hmr(args.hmr, rep, device, unsafe)
    for which in ("body", "hand", "face"):
        p = getattr(args, f"openpose_{which}")
        if p:
            validate_openpose(p, which, rep, device, unsafe)
    if args.lbam:
        validate_lbam(args.lbam, rep, device, unsafe)
    rep.dump()
    return 1 if rep.failed else 0


if __name__ == "__main__":
    sys.exit(main())
