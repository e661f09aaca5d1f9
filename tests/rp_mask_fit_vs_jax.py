"""Phase 10 (c) of ``chip_smoke.py`` — the RenderPeople app's ``--use_mask
--tasks smplify`` scan fit — run by the JAX app and by the port's app on
the CPU, side by side, to see whether both end as far from the keypoints.

The inputs are rebuilt with ``chip_smoke.py``'s seeded writers
(``write_rp_scans``, ``write_rp_keypoints``): the synthetic SMPL written
as the ``--model_path`` asset, the seeded HMR checkpoint, the scan as an
OBJ with the committed 2048^2 JPEG, BODY_25 JSONs of the ground truth's
joints in the app's ring views.  What the card made in the smoke comes
from the file ``python3 chip_smoke.py --save-rp NPZ`` wrote: the posed
scan and its joints, the 8 views the app rendered (written where both
apps find their cached views) and the 96^3 distance volume (handed to
both apps in place of their own build).  Without the file, everything is
made here on the CPU (slow at full size: the rendering and the volume).
Both apps run the same argv; each prints its loss at the gate, after it
and at the end, and the fitted joints' mean reprojection error (px of
the 512^2 views) against the noiseless keypoints, as phase 10 measures
it.

    JAX_PLATFORMS=cpu python -m tests.rp_mask_fit_vs_jax [NPZ] \\
        [--iters 120] [--subdivisions 2]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

import chip_smoke as cs


def reprojection_px(out_dir, joints_clean, w2cs, K):
    params = np.load(os.path.join(out_dir, cs.RP_SUBJECT, "smplify",
                                  "smpl_parameter.npy"),
                     allow_pickle=True).item()
    px = np.linalg.norm(np.stack([
        cs.project(params["joints"][:25], np.linalg.inv(w2c), K)
        for w2c in w2cs]) - joints_clean, axis=-1).mean()
    trace = json.loads(open(os.path.join(out_dir,
                                         "loss_trace.jsonl")).readline())
    return float(px), trace["losses"]


def write_views(out_dir, z):
    """The card's rendered views where the app looks for cached ones."""
    from bodyfitting_torch.io.images import imwrite

    for kind in ("images", "masks"):
        d = os.path.join(out_dir, cs.RP_SUBJECT, kind)
        os.makedirs(d, exist_ok=True)
        for i, img in enumerate(z[kind]):
            imwrite(os.path.join(d, "%02d.png" % i), img)


def use_card_volume(z):
    """Both packages' ``build_distance_volume`` return the card's volume
    (the apps build one per scan)."""
    import jax.numpy as jnp

    from bodyfitting_torch.ops import sdf as tsdf
    from bodyfitting_tpu.ops import sdf as jsdf

    fields = {k: z["vol_" + k] for k in ("dist", "face_idx", "origin",
                                         "spacing")}
    tsdf.build_distance_volume = lambda *a, **kw: tsdf.DistanceVolume(
        **{k: torch.as_tensor(v) for k, v in fields.items()})
    jsdf.build_distance_volume = lambda *a, **kw: jsdf.DistanceVolume(
        **{k: jnp.asarray(v) for k, v in fields.items()})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("npz", nargs="?",
                    help="chip_smoke.py --save-rp output (the card's scan)")
    ap.add_argument("--iters", type=int,
                    default=cs.RP_APP_PATH["mask_iters"])
    ap.add_argument("--subdivisions", type=int,
                    default=cs.RP_APP_PATH["subdivisions"],
                    help="the scan's subdivisions when posed here (no NPZ)")
    cli = ap.parse_args()

    from bodyfitting_torch.apps import renderpeople as papp
    from bodyfitting_torch.fitting import texture as tf
    from bodyfitting_torch.models import body_model as bm
    from bodyfitting_torch.models.hmr import seeded_state_dict
    from bodyfitting_tpu.apps import renderpeople as japp

    size = dict(cs.RP_APP_PATH, subdivisions=cli.subdivisions)
    with tempfile.TemporaryDirectory(prefix="rp_mask_vs_jax_") as root:
        synth = bm.synthetic_model("smpl", num_verts=size["num_verts"],
                                   mesh="sphere", seed=0, device="cpu")
        asset = os.path.join(root, "SMPL_NEUTRAL.npz")
        cs.write_smpl_asset(asset, synth)
        ckpt = os.path.join(root, "hmr.pth")
        torch.save(seeded_state_dict(0), ckpt)
        base = ["--target_dir", os.path.join(root, "scans"),
                "--smpl_type", "smpl", "--viewnum", str(size["viewnum"]),
                "--load_size", str(size["load_size"]), "--model_path", asset,
                "--hmr_checkpoint", ckpt]
        model = papp.load_body_model(papp.config_parser().parse_args(base),
                                     device="cpu")
        scan = z = None
        if cli.npz:
            z = np.load(cli.npz)
            scan = (z["scan_verts"], z["scan_faces"], z["joints"])
            use_card_volume(z)
        data = cs.write_rp_scans(root, model, size, scan=scan)
        verts = data["scan"].verts
        print(f"scan: {len(verts)} vertices, {len(data['scan'].faces)} "
              f"faces ({'the card' if cli.npz else 'posed on the CPU'})",
              flush=True)
        center, _, dist = tf.scene_bounds(verts)
        w2cs = tf.ring_poses(center, size["viewnum"], dist)
        K = tf.default_K(size["load_size"])
        extra = ["--use_mask", "--tasks", "smplify", "--num_iters",
                 str(cli.iters)]
        for which in ("jax", "port"):
            out = os.path.join(root, "out_" + which)
            clean = cs.write_rp_keypoints(out, data["joints"], w2cs, K)
            if z is not None:
                write_views(out, z)
            argv = base + ["--output_dir", out] + extra
            t0 = time.perf_counter()
            if which == "port":
                papp.main(argv, device="cpu")
            else:
                japp.Runner(japp.config_parser().parse_args(argv)).run()
            wall = time.perf_counter() - t0
            px, losses = reprojection_px(out, clean, w2cs, K)
            gate = cli.iters // 3
            print(f"{which}: {cli.iters} iterations in {wall:.1f} s (CPU); "
                  f"loss at the gate / after it / last {losses[gate]:.1f} / "
                  f"{losses[gate + 1]:.1f} / {losses[-1]:.1f}; fitted joints "
                  f"reproject {px:.3f} px from the ground truth's keypoints "
                  f"on average", flush=True)


if __name__ == "__main__":
    main()
