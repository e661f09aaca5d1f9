"""The SDF scan fit of ``chip_smoke.py``'s scan path, run by the JAX
package and by the port on the CPU, side by side, on the distance volume
that the port built on the card.

The 96³ volume of the smoke's 219,008-face scan takes the card's kernel
(about 1.3 s there; far too long for a CPU), so the smoke writes the
problem, the volume and its own fit's result to one file, and this
script reads it:

    python3 chip_smoke.py --save-volume scan_volume.npz  # card
    JAX_PLATFORMS=cpu python -m tests.scan_fit_vs_jax \\
        scan_volume.npz [--iters 600]

It first holds a sample of the volume's cells against the JAX package's
own ``nearest_point_on_mesh``.  Both fits then start from their own
``hmr_init`` mean pose on the same observations and volume, in f32, so
their traces drift apart; what this shows is whether the two packages
end alike: the loss, the mean |displacement| and the mean distance of
the fitted surface to the scan, with and without the displacements
(each vertex against its 32 nearest faces by centroid; the card's exact
query is printed beside it for the card's fit).
Full SMPL width (6846 vertices); at 600 + 600 iterations the JAX fit
takes about two minutes on a few CPU cores.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke as cs
from bodyfitting_torch.convert import distance_volume_from_numpy
from bodyfitting_torch.fitting import body_fitting as tbf
from bodyfitting_torch.fitting import smplify as tfit
from bodyfitting_torch.losses.priors import synthetic_gmm_prior as tprior
from bodyfitting_torch.models import body_model as tbm
from bodyfitting_torch.ops.kernels.nearest import tri_dist2
from bodyfitting_tpu.fitting import body_fitting as jbf
from bodyfitting_tpu.fitting import smplify as jfit
from bodyfitting_tpu.losses.priors import synthetic_gmm_prior as jprior
from bodyfitting_tpu.models import body_model as jbm
from bodyfitting_tpu.ops import nearest as jn
from bodyfitting_tpu.ops import sdf as jsdf


def check_volume(d, n_cells, seed=0):
    """``n_cells`` random cells of the saved volume against the JAX
    package's ``nearest_point_on_mesh`` at their centres."""
    R = d["vol.dist"].shape[0]
    rng = np.random.default_rng(seed)
    ijk = rng.integers(0, R, size=(n_cells, 3))
    r = np.arange(R, dtype=np.float32)
    o, h = d["vol.origin"], d["vol.spacing"]
    pts = np.stack([o[i] + h * r[ijk[:, i]] for i in range(3)], 1)
    _, fid, d2 = jn.nearest_point_on_mesh(
        jnp.asarray(pts), jnp.asarray(d["scan_verts"]),
        jnp.asarray(d["scan_faces"]))
    got = d["vol.dist"][ijk[:, 0], ijk[:, 1], ijk[:, 2]]
    ref = np.sqrt(np.asarray(d2))
    err = float(np.abs(got - ref).max())
    same = int((d["vol.face_idx"][ijk[:, 0], ijk[:, 1], ijk[:, 2]]
                == np.asarray(fid)).sum())
    print(f"volume: {n_cells} random cells against JAX nearest_point_on_mesh:"
          f" dist max abs err {err:.3e} m, face_idx equal in {same}")
    assert err <= 1e-5, err


def residual_mm(v, d, k=32):
    """Mean distance of the vertices ``v [V, 3]`` to the scan, mm: for
    each vertex the nearest of the ``k`` faces whose centroids lie
    closest (a k-d tree; on a scan of centimetre faces the nearest face
    is among them), through the port's plain point-triangle distance."""
    from scipy.spatial import cKDTree

    tri = d["scan_verts"][d["scan_faces"]]                    # [F, 3, 3]
    v = np.asarray(v, np.float32)
    _, cand = cKDTree(tri.mean(1)).query(v, k=k)              # [V, k]
    d2 = tri_dist2(torch.tensor(v)[:, None], torch.tensor(tri[cand]))
    return float(torch.sqrt(d2.amin(1)).mean()) * 1e3


def summary(name, losses, verts, disp, iters, d):
    body, dt = losses[:iters], losses[iters:]
    gate = iters // 3
    k = min(50, len(dt) // 3)
    residual = (residual_mm(verts, d), residual_mm(verts + disp, d))
    print(f"{name}: body loss step 0 / gate / final {body[0]:.1f} / "
          f"{body[gate]:.1f} / {body[-1]:.1f}; displacement loss mean of "
          f"first / last {k} {dt[:k].mean():.6f} / {dt[-k:].mean():.6f}; "
          f"mean |displacement| {np.linalg.norm(disp, axis=1).mean() * 1e3:.2f}"
          f" mm; surface to scan {residual[0]:.2f} mm (body), "
          f"{residual[1]:.2f} mm (SMPL+D)", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("volume", help="the .npz of chip_smoke.py --save-volume")
    ap.add_argument("--iters", type=int, default=cs.SCAN_PATH["num_iters"])
    ap.add_argument("--cells", type=int, default=256)
    args = ap.parse_args()
    d = dict(np.load(args.volume))
    num_verts, imsize = (int(x) for x in d["size"])
    check_volume(d, args.cells)

    c2ws, Ks = list(d["c2ws"]), list(d["Ks"])
    kps = [dict(pose=k) for k in d["keypoints"]]
    sv, sf = d["scan_verts"], d["scan_faces"]
    vol = {k[4:]: d[k] for k in d if k.startswith("vol.")}
    cfg = dict(use_mesh=True, displacement=True, num_iters=args.iters,
               imsize=float(imsize))
    I = args.iters

    tm = tbm.spin_joint_mapper_for_smpl(tbm.synthetic_model(
        "smpl", num_verts=num_verts, mesh="sphere", seed=0,
        device="cpu"))
    tobs = tbf.build_observations(c2ws, Ks, kps, use_hand_face=False,
                                  scan_verts=sv, scan_faces=sf,
                                  build_sdf=False, device="cpu")
    tobs = dataclasses.replace(
        tobs, scan_volume=distance_volume_from_numpy(vol, device="cpu"))
    betas, poses = tbf.hmr_init(None, c2ws[0])
    t = time.perf_counter()
    _, tres, tl = tbf.fit_scan(tm, tfit.FitConfig(**cfg), tobs,
                               tbf.init_params_from_hmr(tm, betas, poses),
                               tprior(device="cpu"))
    t_port = time.perf_counter() - t

    jm = jbm.spin_joint_mapper_for_smpl(jbm.synthetic_model(
        "smpl", num_verts=num_verts, seed=0, mesh="sphere"))
    assert np.array_equal(np.asarray(jm.v_template),
                          tm.v_template.numpy()), "models differ"
    jobs = jbf.build_observations(c2ws, Ks, kps, use_hand_face=False,
                                  scan_verts=sv, scan_faces=sf,
                                  build_sdf=False)
    jobs = dataclasses.replace(jobs, scan_volume=jsdf.DistanceVolume(
        **{k: jnp.asarray(v) for k, v in vol.items()}))
    jb, jp = jbf.hmr_init(None, c2ws[0])
    jinit = jbf.init_params_from_hmr(jm, jb, jp)
    jcfg = jfit.FitConfig(**cfg)
    prior = jprior()
    t = time.perf_counter()
    _, jres, jl = jax.jit(
        lambda o, i: jfit.fit(jm, jcfg, o, i, prior))(jobs, jinit)
    jl = np.asarray(jl)
    t_jax = time.perf_counter() - t

    print(f"{I} + {I} iterations, gate {I // 3}; port {t_port:.1f} s, JAX "
          f"{t_jax:.1f} s (CPU)")
    if I == len(d["fit.losses"]) // 2:
        summary("port on the card", d["fit.losses"], d["fit.vertices"],
                d["fit.displacement"], I, d)
        print("  (the card's own exact query: %.2f mm, %.2f mm)"
              % tuple(d["fit.residual_mm"]))
    summary("port on the CPU", tl.numpy(), tres["vertices"].numpy(),
            tres["displacement"].numpy(), I, d)
    summary("JAX on the CPU", jl, np.asarray(jres["vertices"]),
            np.asarray(jres["displacement"]), I, d)


if __name__ == "__main__":
    torch.set_num_threads(4)
    main()
