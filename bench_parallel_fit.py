#!/usr/bin/env python3
"""The multi-device production fit across cards, under ``torchrun``.

    torchrun --nproc-per-node 4 bench_parallel_fit.py [--frames 8]

Each rank takes card ``LOCAL_RANK`` and joins the NCCL world
(``bodyfitting_torch.parallel.init_world``).  On
``make_production_fit_problem`` (SMPL-X at 10,475 vertices, 4 views, 2
masks of 128^2, the 24^3 volume, 60 iterations): rank 0 fits the whole
batch alone (``fit_frames_batched``), then every rank runs
``fit_sequence_sharded`` on the ``N x 1`` mesh and, for an even N, the
``N/2 x 2`` one; each is held to the single-device fit as the JAX
package's hardware check holds it (pre-gate losses to 1e-3, the last to
0.2), timed on the host clock (a short fit first warms each path), and
its collectives counted and a step's replayed.  Then the SMPL-X forward
vertex-sharded over the N ranks, under ``FUSED_SKINNING = "on"``,
against the whole model's plain forward (2e-5; pad rows exactly 0),
each rank's skinning launch bitwise its plain version.  The runs and
checks are ``chip_smoke.py`` phase 13's (``sharded_fit``,
``loss_errors``, ``tp_forward``).  Rank 0 prints the cards' name and
power limit, then one JSON line; the exit code is non-zero if a check
fails.  ``--device cpu`` runs the same on gloo
(tiny ``--frames``) for a rehearsal.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time


REPO = os.path.dirname(os.path.abspath(__file__))


def timed_fit(fn, device):
    import chip_smoke as cs

    cs.sync(device)
    t0 = time.perf_counter()
    out = fn()
    cs.sync(device)
    return out, time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--device", default=None,
                    help="cpu for a gloo rehearsal (default: the card)")
    cli = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from bodyfitting_torch.fitting import body_fitting as bf
    from bodyfitting_torch.parallel import checks
    from bodyfitting_torch.parallel import sharding as sh

    device = sh.init_world(cli.device)
    rank, world = dist.get_rank(), dist.get_world_size()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = ""
    if rank == 0 and device.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
        print(smi, flush=True)
    model, config, obs, init, prior = checks.make_production_fit_problem(
        n_frames=cli.frames, num_iters=cli.iters, device=device)
    warm = dataclasses.replace(config, num_iters=3)
    B = cli.frames
    frames = [cs._frames_of(obs, i, i + 1) for i in range(B)]
    inits = [cs._frames_of(init, i, i + 1) for i in range(B)]
    out = dict(world=world, device=str(device), frames=B,
               iters=config.num_iters, card=smi, meshes={})
    tol = cs.PHASE13
    ok = True
    if rank == 0:
        bf.fit_frames_batched(model, warm, frames, inits, prior)
        single, out["single_s"] = timed_fit(
            lambda: bf.fit_frames_batched(model, config, frames, inits,
                                          prior), device)
        ref = single[2].cpu().numpy()
    dist.barrier()
    gate = config.num_iters // config.stage_gate_den
    shapes = [(world, 1)] + ([(world // 2, 2)] if world % 2 == 0 else [])
    for shape in shapes:
        mesh = sh.make_mesh(*shape)
        sh.fit_sequence_sharded(model, warm, obs, init, prior, mesh=mesh)
        _, r = cs.sharded_fit(model, config, obs, init, prior, mesh, device,
                              reps=20)
        losses = r.pop("losses").numpy()
        del r["vertices"]
        if rank == 0:
            r["pre_gate_rel_err"], r["last_rel_err"] = cs.loss_errors(
                losses, ref, gate)
            r["speedup"] = out["single_s"] / r["wall"]
            ok &= (r["pre_gate_rel_err"] <= tol["pre_gate_rtol"]
                   and r["last_rel_err"] <= tol["last_rtol"])
        out["meshes"]["%dx%d" % shape] = r
    tpr = cs.tp_forward(10475, device, time_kernel=True)
    out["tp"] = tpr
    ok &= (tpr["pad_zero"] and max(tpr["vert_err"], tpr["joint_err"])
           <= tol["tp_atol"])
    dist.barrier()
    if rank == 0:
        out["ok"] = bool(ok)
        print(json.dumps(out), flush=True)
    dist.destroy_process_group()
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
