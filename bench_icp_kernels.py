#!/usr/bin/env python3
"""Time the silhouette ICP kernels of one or more checkouts on one GPU.

    python3 bench_icp_kernels.py [CHECKOUT ...]     # default: this one

For each checkout (a directory holding ``chip_smoke.py`` and
``bodyfitting_torch/``), in its own process and in the order given, this
builds the kernels, runs ``chip_smoke.py``'s main path (phase 3, the
8-frame mask fit), and prints one JSON line ``ICP {...}`` with the sha1
of the fit's loss trace, its launch counts and step times, and, at the
inputs the fit hands ``contour_match_full`` and ``rows_scatter_add`` at
its final state, each kernel's device time (CUDA events, two runs of
300 launches), whether it equals that checkout's plain version bitwise,
its time on seeded random inputs of the same shape (for the scatter,
indices drawn uniformly, so runs are short), the valid share of the
candidates and the longest run of one index.  Give a parent checkout
before and after this one (parent, change, change, parent) to compare
two commits on one card.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys


def measure(root: str) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from bodyfitting_torch.fitting import body_fitting as bf
    from bodyfitting_torch.ops import kernels as K

    cs.phase_device()
    cs.phase_build()
    seen = {}
    fit = bf.fit_frames_batched

    def recorded(*a, **kw):
        out = fit(*a, **kw)
        seen["losses"] = out[2].detach().cpu().numpy()
        return out

    bf.fit_frames_batched = recorded
    state = cs.phase_main_path(False)
    calls = cs.capture_kernel_inputs(state)
    ((cargs, _),) = calls["contour_match_full"]
    ((sargs, _),) = calls["rows_scatter_add"]
    contour, proj, valid, inside = cargs
    idx, g, M = sargs

    rng = np.random.default_rng(0)

    def like(t, lo, hi):
        return torch.as_tensor(rng.uniform(lo, hi, size=tuple(t.shape)),
                               dtype=t.dtype, device=t.device)

    rand_c = (like(contour, 100, 400), like(proj, 100, 400),
              torch.ones_like(valid), like(inside, 0, 1))
    rand_s = (torch.as_tensor(rng.integers(0, M, size=tuple(idx.shape)),
                              dtype=idx.dtype, device=idx.device),
              like(g, -1, 1), M)

    def times(fn, args):
        return [cs.cuda_ms(lambda: fn(*args), reps=300) for _ in range(2)]

    got = K.contour_match_full(*cargs)
    ref = K.contour_match_full_plain(*cargs)
    s1 = K.rows_scatter_add(*sargs)
    s2 = K.rows_scatter_add(*sargs)
    sref = K.rows_scatter_add_plain(*sargs)
    torch.cuda.synchronize()
    keep = (idx >= 0) & (idx < M)
    rows = idx.long() + M * torch.arange(idx.shape[0],
                                         device=idx.device)[:, None]
    runs = torch.unique(rows[keep], return_counts=True)[1]
    digest = hashlib.sha1(
        np.ascontiguousarray(seen["losses"]).tobytes()).hexdigest()
    return dict(
        checkout=root, device=torch.cuda.get_device_name(0), sha1=digest,
        launches=state["launches"], fit_wall_s=state["wall"],
        pre_gate_step_ms=state["pre_ms"], post_gate_step_ms=state["post_ms"],
        contour_ms=times(K.contour_match_full, cargs),
        contour_random_ms=times(K.contour_match_full, rand_c),
        contour_bitwise_plain=all(torch.equal(a, b)
                                  for a, b in zip(got, ref)),
        valid_share=float((valid > 0).float().mean()),
        scatter_ms=times(K.rows_scatter_add, sargs),
        scatter_random_ms=times(K.rows_scatter_add, rand_s),
        scatter_repeats_bitwise=bool(torch.equal(s1, s2)),
        scatter_bitwise_plain=bool(torch.equal(s1, sref)),
        longest_run=int(runs.max()) if runs.numel() else 0,
    )


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--one"]:
        print("ICP " + json.dumps(measure(args[1])), flush=True)
        return 0
    here = os.path.dirname(os.path.abspath(__file__))
    rc = 0
    for root in args or [here]:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", root],
            capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("ICP ")]
        print(lines[-1] if lines else f"ICP failed for {root} (rc "
              f"{proc.returncode}): {proc.stderr[-2000:]}", flush=True)
        rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
