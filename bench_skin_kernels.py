#!/usr/bin/env python3
"""Time the fused-skinning kernels of one or more checkouts on one GPU.

    python3 bench_skin_kernels.py [CHECKOUT ...]     # default: this one
    python3 bench_skin_kernels.py --geometries       # this checkout

For each checkout (a directory holding ``chip_smoke.py`` and
``bodyfitting_torch/``), in its own process and in the order given, this
builds the kernels and prints one JSON line ``SKIN {...}``: at the four
shapes that ``chip_smoke.py``'s phase 9 times (8 frames at 564, 3,035 and
10,475 vertices, the keypoint fit's, the mask fit's and the output's, and
128 frames at 10,475; 55 joints), on seeded inputs, each kernel's device
time (CUDA events, two runs of back-to-back launches), whether out, dA
and dvp equal that checkout's plain versions bitwise and whether two
backward launches repeat bitwise, and the "auto" path's times
(``torch.matmul`` + ``einsum``, and their autograd backward); and the SM
clock and power that ``nvidia-smi`` reads while each kernel runs back to
back for about a second at 128 frames, which turns the times into
instructions a cycle.  Give a parent checkout before and after this one
(parent, change, change, parent) to compare two commits on one card.

``--geometries`` times the backward's two launch geometries apart, the
latency one and the throughput one (``ops/kernels/skinning.py:
launch_geometry``), at 55 joints, 4 to 512 frames of 564, 3,035 and
10,475 vertices, around where the kernel changes from one to the other,
and prints one JSON line ``GEOM {...}``: each
geometry's device time (two timings each, in the order latency,
throughput, throughput, latency), whether it equals the plain version
bitwise, and which one the kernel takes by size.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

SHAPES = ((8, 564), (8, 3035), (8, 10475), (128, 10475))
JOINTS = 55
GEOMETRY_SHAPES = tuple(
    (B, V) for V, frames in (
        (564, (8, 16, 24, 32, 48, 64, 96, 128, 256, 512)),
        (3035, (8, 12, 16, 20, 24, 28, 32, 64, 128, 256)),
        (10475, (4, 8, 12, 16, 20, 24, 28, 32, 48, 64, 96, 128)))
    for B in frames)


def inputs(B, V, J, device, seed=0):
    """Seeded W (normalised, every 11th row without weight), A, vp, g."""
    import torch

    rng = np.random.default_rng(seed + B + V)
    W = rng.random((V, J)) ** 8
    W /= W.sum(1, keepdims=True)
    W[::11] = 0.0
    A = rng.normal(scale=0.1, size=(B, J, 12)) + np.eye(3, 4).reshape(12)
    vp = rng.normal(size=(B, V, 3))
    g = rng.normal(size=(B, V, 3))
    return [torch.as_tensor(x.astype(np.float32), device=device)
            for x in (W, A, vp, g)]


def auto_path(W, A, vp):
    """The "auto" skinning (two calls), as ``models/body_model.py`` runs it
    with the kernels off."""
    import torch

    B, V, _ = vp.shape
    T = torch.matmul(W, A).reshape(B, V, 3, 4)
    return torch.einsum("bvij,bvj->bvi", T[..., :3], vp) + T[..., 3]


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def clocks_under(fn, seconds=1.0):
    """``nvidia-smi``'s SM clock (MHz) and power draw (W), sampled every
    100 ms while ``fn`` runs back to back for about ``seconds``."""
    import time

    import torch

    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=30)
    rows = [[float(x) for x in ln.split(",")] for ln in out.splitlines()
            if ln.strip()]
    return dict(sm_mhz=[r[0] for r in rows], power_w=[r[1] for r in rows])


def measure(root: str) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from bodyfitting_torch.ops import kernels as K

    cs.phase_device()
    cs.phase_build()
    rows = []
    for B, V in SHAPES:
        W, A, vp, g = inputs(B, V, JOINTS, "cuda")
        out = K.skin_forward(W, A, vp)
        dA1, dvp1 = K.skin_backward(W, A, vp, g)
        dA2, dvp2 = K.skin_backward(W, A, vp, g)
        ref = K.skin_forward_plain(W, A, vp)
        rdA, rdvp = K.skin_backward_plain(W, A, vp, g)
        torch.cuda.synchronize()
        reps = 200 if B * V < 2e5 else 50
        a_, v_ = A.clone().requires_grad_(True), vp.clone().requires_grad_(True)
        y = auto_path(W, a_, v_)
        # autograd's host cost a call would outrun the timer's spin kernel
        # over 200 calls: the "auto" path takes 20
        rows.append(dict(
            B=B, V=V, J=JOINTS,
            fwd_ms=[cs.cuda_ms(lambda: K.skin_forward(W, A, vp), reps=reps)
                    for _ in range(2)],
            bwd_ms=[cs.cuda_ms(lambda: K.skin_backward(W, A, vp, g),
                               reps=reps) for _ in range(2)],
            auto_fwd_ms=cs.cuda_ms(lambda: auto_path(W, A, vp), reps=20),
            auto_bwd_ms=cs.cuda_ms(
                lambda: torch.autograd.grad(y, [a_, v_], g, retain_graph=True),
                reps=20),
            fwd_bitwise_plain=bool(torch.equal(out, ref)),
            bwd_bitwise_plain=bool(torch.equal(dA1, rdA)
                                   and torch.equal(dvp1, rdvp)),
            bwd_repeats_bitwise=bool(torch.equal(dA1, dA2)
                                     and torch.equal(dvp1, dvp2)),
        ))
        if B == 128:
            rows[-1]["fwd_clocks"] = clocks_under(
                lambda: K.skin_forward(W, A, vp))
            rows[-1]["bwd_clocks"] = clocks_under(
                lambda: K.skin_backward(W, A, vp, g))
    return dict(checkout=root, device=torch.cuda.get_device_name(0),
                card=card(), shapes=rows)


def geometries() -> dict:
    """The backward's latency and throughput geometries timed apart at
    :data:`GEOMETRY_SHAPES` (see the module's docstring)."""
    import torch

    import chip_smoke as cs
    from bodyfitting_torch.ops.kernels import skinning as S

    cs.phase_device()
    cs.phase_build()
    rows = []
    for B, V in GEOMETRY_SHAPES:
        W, A, vp, g = inputs(B, V, JOINTS, "cuda")
        rdA, rdvp = S.skin_backward_plain(W, A, vp, g)
        reps = 200 if B * V < 2e5 else 50
        wide = S.launch_geometry(B, V, JOINTS, True) == S.launch_geometry(
            B, V, JOINTS, True, 1)
        row = dict(B=B, V=V, pairs=B * V,
                   by_size=("latency", "throughput")[wide])
        for wide, name in ((0, "latency"), (1, "throughput")):
            dA, dvp = S._launch_backward(W, A, vp, g, wide)
            torch.cuda.synchronize()
            row[f"{name}_bitwise_plain"] = bool(torch.equal(dA, rdA)
                                                and torch.equal(dvp, rdvp))
            row[f"{name}_ms"] = []
        for wide, name in ((0, "latency"), (1, "throughput"),
                           (1, "throughput"), (0, "latency")):
            row[f"{name}_ms"].append(cs.cuda_ms(
                lambda w=wide: S._launch_backward(W, A, vp, g, w), reps=reps))
        rows.append(row)
    return dict(device=torch.cuda.get_device_name(0), card=card(),
                wide_frames=S.WIDE_FRAMES, wide_pairs=S.WIDE_PAIRS,
                shapes=rows)


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--one"]:
        print("SKIN " + json.dumps(measure(args[1])), flush=True)
        return 0
    if args == ["--geometries"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        print("GEOM " + json.dumps(geometries()), flush=True)
        return 0
    here = os.path.dirname(os.path.abspath(__file__))
    rc = 0
    for root in args or [here]:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", root],
            capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("SKIN ")]
        print(lines[-1] if lines else f"SKIN failed for {root} (rc "
              f"{proc.returncode}): {proc.stderr[-2000:]}", flush=True)
        rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
