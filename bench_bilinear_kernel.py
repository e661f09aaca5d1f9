#!/usr/bin/env python3
"""Time the stay-inside sampler (``bilinear_cov_grads``) of one or more
checkouts on one GPU.

    python3 bench_bilinear_kernel.py [CHECKOUT ...]   # default: this one
    python3 bench_bilinear_kernel.py --variants       # design variants

For each checkout (a directory holding ``chip_smoke.py`` and
``bodyfitting_torch/``), in its own process and in the order given, this
builds the kernels, runs ``chip_smoke.py``'s main path (phase 3, the
8-frame mask fit) and prints one JSON line ``BILINEAR {...}``: the sha1
of the fit's loss trace, its launch counts and step times, and, at the
inputs that checkout's fit hands the kernel at its final state (the
stay-inside call and the matched-pixel lookup), whether the kernel
equals that checkout's plain version bitwise, and its device time warm
(CUDA events around 300 back-to-back launches, twice) and cold (the L2
flushed by a 128 MiB write before each launch, each launch between its
own pair of events: the median and mean of 200, twice), in the image
type the checkout's fit samples and, where the checkout takes another
(a bit mask and f32), in that too.  Give a
parent checkout before and after this one (parent, change, change,
parent) to compare two commits on one card.

``--variants`` builds ``bench_bilinear_variants.cu`` (the kernel of
``csrc/bilinear.cu`` with its design choices open as ``-D`` macros, and a
u8 image type) once for each entry of :data:`VARIANTS` (points a thread,
threads a block, tap loads, u8 conversion, view index), captures the
fit's inputs once, times every variant in list order and then in reverse
order, and prints one JSON line ``VARIANT {...}`` a build: the warm and
cold times of both calls in three image types (the bit mask, u8 and f32),
whether each equals the plain version bitwise (the probe that reads no
taps does not), and ptxas's register report; then a line of references:
a one-thread kernel (the launch floor, ``torch.cuda._sleep`` of 0
cycles), ``grid_sample``, a fill of the ``[BV, 6, N]`` output alone and
the bound.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

# name -> -D values of bench_bilinear_variants.cu, each given in full so
# that a variant does not move with the file's defaults: BILINEAR_VEC points a
# vector, BILINEAR_GROUPS vectors a thread, BILINEAR_THREADS threads a
# block, BILINEAR_TAPS the tap loads (0 plain, 1 read-only path, 2
# read-only with an L2 evict_last hint, 3 none: a probe whose results are
# wrong), BILINEAR_U8CVT a u8 pixel or mask bit to float (0 by
# conversion, 1 by a float subtraction), BILINEAR_DIV a point's view (0
# by division, 1 by a multiply and a shift).
_BASE = dict(VEC=1, GROUPS=1, THREADS=256, TAPS=1, U8CVT=0, DIV=1)
VARIANTS = {name: dict(_BASE, **d) for name, d in {
    "1 point a thread": {},
    "1 point, hardware division": dict(DIV=0),
    "1 point, 128 threads": dict(THREADS=128),
    "1 point, 512 threads": dict(THREADS=512),
    "1 point, 1024 threads": dict(THREADS=1024),
    "1 point, u8 by subtraction": dict(U8CVT=1),
    "1 point, plain tap loads": dict(TAPS=0),
    "1 point, evict_last taps": dict(TAPS=2),
    "1 point, no taps (probe)": dict(TAPS=3),
    "2 points (1 vector)": dict(VEC=2),
    "4 points (2 vectors)": dict(VEC=2, GROUPS=2),
    "4 points (4 scalars)": dict(GROUPS=4),
    "8 points (4 vectors)": dict(VEC=2, GROUPS=4),
    "4 points, 128 threads": dict(VEC=2, GROUPS=2, THREADS=128),
    "4 points, 512 threads": dict(VEC=2, GROUPS=2, THREADS=512),
    "4 points, plain tap loads": dict(VEC=2, GROUPS=2, TAPS=0),
    "4 points, evict_last taps": dict(VEC=2, GROUPS=2, TAPS=2),
    "4 points, no taps (probe)": dict(VEC=2, GROUPS=2, TAPS=3),
}.items()}
GEOMETRY_KEYS = ("blocks", "threads", "points", "vector", "tap_load",
                 "u8_cvt", "view_div")


def capture(root: str):
    """Build, run the checkout's main path and return ``(state, the
    loss trace's sha1, [(name, args, kwargs)] of the two sampler calls
    at the fit's final state)``."""
    import numpy as np

    import chip_smoke as cs
    from bodyfitting_torch.fitting import body_fitting as bf

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
    calls = cs.capture_kernel_inputs(state)["bilinear_cov_grads"]
    (look_args, look_kw), (stay_args, stay_kw) = calls
    digest = hashlib.sha1(
        np.ascontiguousarray(seen["losses"]).tobytes()).hexdigest()
    return state, digest, [("stay-inside", stay_args, stay_kw),
                           ("lookup", look_args, look_kw)]


def this_chip_smoke():
    """This checkout's ``chip_smoke`` (its timing helpers), whichever
    checkout's package the process imported."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "bench_bilinear_chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def times(tools, fn):
    warm = [tools.cuda_ms(fn, reps=300) for _ in range(2)]
    cold = [tools.cold_ms(fn) for _ in range(2)]
    return dict(warm_ms=warm, cold_median_ms=[c[0] for c in cold],
                cold_mean_ms=[c[1] for c in cold])


def measure(root: str) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    from bodyfitting_torch.ops import kernels as K

    tools = this_chip_smoke()
    state, digest, calls = capture(root)
    out = dict(checkout=root, device=torch.cuda.get_device_name(0),
               card=card(), sha1=digest, launches=state["launches"],
               fit_wall_s=state["wall"], pre_gate_step_ms=state["pre_ms"],
               post_gate_step_ms=state["post_ms"])
    for what, (img, xy), kw in calls:
        res = {}
        # a checkout whose fit samples f32 crops takes f32 only
        images = ({"f32": img} if img.dtype == torch.float32
                  else tools.bilinear_images(img))
        for kind, im in images.items():
            got = K.bilinear_cov_grads(im, xy, **kw)
            ref = K.bilinear_cov_grads_plain(im, xy, **kw)
            torch.cuda.synchronize()
            res[kind] = dict(
                bitwise_plain=bool(torch.equal(got, ref)),
                **times(tools, lambda: K.bilinear_cov_grads(im, xy, **kw)))
        out[what] = dict(image=str(img.dtype).replace("torch.", ""),
                         BV=img.shape[0], N=xy.shape[1],
                         crop=list(img.shape[1:]), **res)
    return out


def build_variants():
    """``{name: (library path, ptxas report)}``:
    ``bench_bilinear_variants.cu`` built once a variant, all compilers
    started together."""
    from bodyfitting_torch.ops.kernels import _build

    src = os.path.join(HERE, "bench_bilinear_variants.cu")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    procs = {}
    for i, (name, defs) in enumerate(VARIANTS.items()):
        path = os.path.join(_build.BUILD_DIR, f"libbilinear_variant{i}.so")
        flags = [f"-DBILINEAR_{k}={v}" for k, v in defs.items()]
        procs[name] = (path, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", path, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name!r} failed to build:\n{log}")
        regs = [ln.strip() for ln in log.splitlines() if "Used" in ln]
        built[name] = (path, regs)
    return built


def variant_fn(path: str, kind: str):
    """A caller ``call(img, xy, W, with_grads, with_cov)`` of the variant
    library's sampler for ``kind`` images ("f32", "u8" or "bits", a bit
    mask of width ``W``), and its geometry."""
    import torch

    lib = ctypes.CDLL(path)
    sym = getattr(lib, {"f32": "bilinear_cov_grads_f32",
                        "u8": "bilinear_cov_grads_u8",
                        "bits": "bilinear_cov_grads_b1"}[kind])
    sym.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    sym.restype = ctypes.c_int
    geo = lib.bilinear_cov_grads_geometry
    geo.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
    geo.restype = None

    def call(img, xy, W, with_grads, with_cov):
        BV, H = img.shape[:2]
        N = xy.shape[1]
        out = torch.empty((BV, 6, N), device=img.device)
        err = sym(img.data_ptr(), xy.data_ptr(), out.data_ptr(), BV, H, W,
                  N, int(with_grads), int(with_cov),
                  torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"variant launch failed (cudaError {err})")
        return out

    def geometry(BV, N):
        out = (ctypes.c_int * len(GEOMETRY_KEYS))()
        geo(BV, N, out)
        return dict(zip(GEOMETRY_KEYS, out))

    return call, geometry


def variants() -> list:
    sys.path.insert(0, HERE)
    os.chdir(HERE)
    import torch
    import torch.nn.functional as F

    from bodyfitting_torch.ops import kernels as K

    tools = this_chip_smoke()
    state, digest, calls = capture(HERE)
    built = build_variants()
    rows = {name: dict(variant=name, defines=VARIANTS[name], ptxas=regs)
            for name, (_, regs) in built.items()}
    # every variant timed twice, once in each order, so that a drift of
    # the card's clocks over the run shows as a spread, not as a ranking
    order = list(built)
    for names in (order, order[::-1]):
        for name in names:
            path, _ = built[name]
            row = rows[name]
            for what, (img, xy), kw in calls:
                bits, f32 = tools.bilinear_images(img).values()
                images = {"bits": bits, "u8": f32.to(torch.uint8),
                          "f32": f32}
                W = images["f32"].shape[2]
                ref = K.bilinear_cov_grads_plain(images["f32"], xy, **kw)
                for kind, im in images.items():
                    call, geometry = variant_fn(path, kind)
                    got = call(im, xy, W, **kw)
                    torch.cuda.synchronize()
                    t = times(tools, lambda: call(im, xy, W, **kw))
                    cell = row.setdefault(f"{what} {kind}", dict(
                        geometry=geometry(img.shape[0], xy.shape[1]),
                        bitwise_plain=True, warm_ms=[], cold_median_ms=[],
                        cold_mean_ms=[]))
                    cell["bitwise_plain"] &= bool(torch.equal(got, ref))
                    for k, v in t.items():
                        cell[k] += v
    lines = list(rows.values())
    ref = dict(variant="references", sha1=digest,
               device=torch.cuda.get_device_name(0), card=card(),
               launch_floor_ms=[tools.cuda_ms(lambda: torch.cuda._sleep(0),
                                              reps=300) for _ in range(2)])
    for what, (img, xy), kw in calls:
        f32 = tools.bilinear_images(img)["f32"]
        BV, Hc, Wc = f32.shape
        scale = torch.tensor([2.0 / (Wc - 1), 2.0 / (Hc - 1)],
                             device=xy.device)
        grid = (xy * scale - 1.0)[:, None]
        ref[f"{what} grid_sample"] = times(tools, lambda: F.grid_sample(
            f32[:, None], grid, mode="bilinear", padding_mode="zeros",
            align_corners=True))
        # the output alone: a fill of the [BV, 6, N] f32 result
        out = torch.empty((BV, 6, xy.shape[1]), device=xy.device)
        ref[f"{what} output fill"] = times(tools, out.zero_)
        ref[f"{what} bound"] = tools.bilinear_bound(f32, xy)
    lines.append(ref)
    return lines


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--one"]:
        print("BILINEAR " + json.dumps(measure(args[1])), flush=True)
        return 0
    if args[:1] == ["--variants"]:
        for row in variants():
            print("VARIANT " + json.dumps(row), flush=True)
        return 0
    rc = 0
    for root in args or [HERE]:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", root],
            capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("BILINEAR ")]
        print(lines[-1] if lines else f"BILINEAR failed for {root} (rc "
              f"{proc.returncode}): {proc.stderr[-2000:]}", flush=True)
        rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
