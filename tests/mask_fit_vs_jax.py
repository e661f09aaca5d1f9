"""The staged mask fit of ``chip_smoke.py``'s main path, run by the JAX
package and by the port on the CPU, side by side.

Both fits start from one problem: the port's synthetic SMPL-X model,
keypoints, masks, contours and crops as ``chip_smoke.make_problem``
builds them, handed to the JAX package as numpy (the JAX
``synthetic_model`` gives the same arrays for the same seed).  The JAX
side runs its XLA silhouette route, which the port's plain versions
match.  Both run in f32, so the traces drift apart over 600 steps; what
this shows is whether the two fits behave alike after the stage gate.

    JAX_PLATFORMS=cpu python -m tests.mask_fit_vs_jax [--frames 1]

Full SMPL-X width (10475 vertices), 48 keypoint views and 8 masks at
512x512 per frame; one frame takes about two minutes on a few CPU cores.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke as cs
from bodyfitting_torch.fitting import body_fitting as tbf
from bodyfitting_torch.fitting import smplify as tfit
from bodyfitting_torch.losses.priors import synthetic_gmm_prior as tprior
from bodyfitting_torch.models import body_model as tbm
from bodyfitting_tpu.fitting import body_fitting as jbf
from bodyfitting_tpu.fitting import smplify as jfit
from bodyfitting_tpu.losses import silhouette as jsil
from bodyfitting_tpu.losses.priors import synthetic_gmm_prior as jprior
from bodyfitting_tpu.models import body_model as jbm


def jax_frame(x, f):
    """Frame ``f`` of a port dataclass of ``[B, ...]`` tensors, as the
    JAX dataclass of the same fields."""
    return {k.name: jnp.asarray(getattr(x, k.name)[f].numpy())
            for k in dataclasses.fields(x) if getattr(x, k.name) is not None}


def summary(losses, gate):
    """Per frame: step 0, the gate, the first masked step, the post-gate
    peak, the final step, and the means of the first and last 50 masked
    steps."""
    post = losses[:, gate + 1:]
    return np.stack([losses[:, 0], losses[:, gate], post[:, 0],
                     post.max(1), post[:, -1], post[:, :50].mean(1),
                     post[:, -50:].mean(1)], 1)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=1)
    ap.add_argument("--iters", type=int, default=cs.MAIN_PATH["num_iters"])
    args = ap.parse_args()
    S = cs.MAIN_PATH
    tm = tbm.synthetic_model("smplx", num_verts=S["num_verts"], seed=0,
                             device="cpu")
    obs_list, init_list, crop = cs.make_problem(
        tm, args.frames, S["n_views"], S["n_mask_views"], S["imsize"],
        S["focal"], S["dist"], S["contour_points"], seed=0, device="cpu")
    cfg = dict(use_mask=True, num_iters=args.iters, imsize=float(S["imsize"]))
    gate = args.iters // 3

    t = time.perf_counter()
    _, _, tl = tbf.fit_frames_batched(tm, tfit.FitConfig(**cfg), obs_list,
                                      init_list, tprior(device="cpu"))
    t_port = time.perf_counter() - t

    jm = jbm.synthetic_model("smplx", num_verts=S["num_verts"], seed=0)
    assert np.array_equal(np.asarray(jm.v_template),
                          tm.v_template.numpy()), "models differ"
    jobs = [jfit.Observations(**jax_frame(o, 0)) for o in obs_list]
    jinit = []
    for p in init_list:
        d = jax_frame(p.body, 0)
        jinit.append(jfit.FitParams(
            body=jbm.BodyParams(**d),
            global_transl=jnp.asarray(p.global_transl[0].numpy()),
            body_scale=jnp.asarray(p.body_scale[0].numpy())))
    jsil.STAY_INSIDE = jsil.CONTOUR_MATCH = "xla"
    t = time.perf_counter()
    _, _, jl = jbf.fit_frames_batched(jm, jfit.FitConfig(**cfg), jobs, jinit,
                                      jprior())
    jl = np.asarray(jl)
    t_jax = time.perf_counter() - t

    print(f"{args.frames} frame(s), {args.iters} iterations, gate {gate}, "
          f"crop {crop}; port {t_port:.1f} s, JAX {t_jax:.1f} s (CPU)")
    print("columns: step 0, gate, first masked step, post-gate peak, final, "
          "mean of first 50 masked steps, mean of last 50")
    for name, L in (("port", tl.numpy()), ("jax", jl)):
        for f, row in enumerate(summary(L, gate)):
            print(f"{name} frame {f}: " + " ".join(f"{v:.1f}" for v in row))


if __name__ == "__main__":
    torch.set_num_threads(4)
    main()
