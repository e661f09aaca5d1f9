"""The control, the planted faults and the sound alternative routes of
the fit cells, each a context manager that changes the program's timed
path while it is open, and a reader that runs units under each and
returns the compared numbers.

  control           the program with its TF32 path on (PyTorch's
                    ``allow_tf32`` switches): float32 computed in the
                    nearest precision below the configuration's;
  state_unchanged   every Adam step returns its state unchanged;
  half_batch        half of the batch left out: the second half of a
                    unit's frames never updated (a batch of one scan:
                    the volume built from half of the scan's faces);
  answer_altered    one fitted vertex moved 1 mm where the fit's result
                    is made;
  mask_half         the silhouette terms of the second half of a batch's
                    frames left out (a mask fit only);
  fused_mask        sound: the program's fused per-view mask term
                    (``FUSED_MASK_TERM = "fused"``), whose float32 sums
                    run in another order;
  fused_skinning    sound: the program's fused skinning kernels
                    (``FUSED_SKINNING = "on"``).

Run at a cell's own size on the card, on several seeds:

    python3 -m benchmark.tests.faults --workload NAME --seeds 1 2 3
    python3 -m benchmark.tests.faults --workload genebody_mask_b8 \
        --seeds 1 2 3 --variants sound fused_mask fused_skinning --units 0 5
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile

VARIANTS = ("sound", "control", "state_unchanged", "half_batch",
            "answer_altered", "mask_half")
SOUND_ROUTES = ("fused_mask", "fused_skinning")


@contextlib.contextmanager
def _patched(obj, name, make):
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


@contextlib.contextmanager
def variant(name, scan=False):
    import torch

    from bodyfitting_torch.fitting import smplify
    from bodyfitting_torch.losses import silhouette
    from bodyfitting_torch.models import body_model
    from bodyfitting_torch.ops import sdf

    if name == "sound":
        yield
    elif name == "fused_mask":
        with _patched(silhouette, "FUSED_MASK_TERM", lambda _: "fused"):
            yield
    elif name == "fused_skinning":
        with _patched(body_model, "FUSED_SKINNING", lambda _: "on"):
            yield
    elif name == "control":
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old
    elif name == "state_unchanged":
        with _patched(smplify.Adam, "step", lambda orig: lambda self, g: None):
            yield
    elif name == "half_batch" and scan:
        def half(orig):
            def nearest(points, tri, tie_verts=None):
                return orig(points, tri[:len(tri) // 2].contiguous(),
                            tie_verts=tie_verts)
            return nearest
        with _patched(sdf, "nearest_d2_idx", half):
            yield
    elif name == "half_batch":
        def half(orig):
            def step(self, grads):
                grads = [g.clone() for g in grads]
                for g in grads:
                    g[g.shape[0] // 2:] = 0
                orig(self, grads)
            return step
        with _patched(smplify.Adam, "step", half):
            yield
    elif name == "answer_altered":
        def altered(orig):
            def fit_result(model, params, obs):
                out = orig(model, params, obs)
                out["vertices"][0, 0, 0] += 1e-3
                return out
            return fit_result
        with _patched(smplify, "fit_result", altered):
            yield
    elif name == "mask_half":
        def half(orig):
            def silhouette_loss(*args, **kw):
                out = orig(*args, **kw)
                keep = torch.ones_like(out)
                keep[len(out) // 2:] = 0
                return out * keep
            return silhouette_loss
        with _patched(smplify, "silhouette_loss", half):
            yield
    else:
        raise ValueError(name)


def readings(workload, seeds, variants=VARIANTS, root=None, device="cuda",
             bench_json=None, units=None):
    """``{variant: [{number: value} for each seed and unit]}``: a set-up
    a seed, then under each variant in force the units ``units`` of the
    pool (by default one unit a variant, the i-th for the i-th), each
    checked as a run checks; a mask cell's frames also print their
    masked-step loss and gradient gaps before and after the near-ties'
    allowance, and the gradient's allowance as a share of the leaf."""
    from benchmark import harness

    cell = harness.cell(workload, root=root or harness.HERE,
                        bench_json=bench_json)
    drv = cell["driver"]
    scan = cell["work"]["driver"] == "scan_fit"
    out = {v: [] for v in variants}
    for seed in seeds:
        state = drv.setup(cell, seed, device, tempfile.mkdtemp(),
                          harness.Spans(device))
        for i, v in enumerate(variants):
            for u in ([i] if units is None else units):
                with variant(v, scan):
                    rec = drv.unit(state, u)
                drv.release([rec])
                out[v].append({k: val
                               for k, val, _ in drv.check(state, [rec])})
                print(workload, seed, v, u, out[v][-1], flush=True)
                detail = state.get("detail", [])
                for d in detail:
                    print("   frame", d, flush=True)
                detail.clear()
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--variants", nargs="+", default=list(VARIANTS),
                   choices=VARIANTS + SOUND_ROUTES)
    p.add_argument("--units", type=int, nargs="+",
                   help="the pool's units each variant runs (default: "
                   "the i-th unit for the i-th variant)")
    args = p.parse_args(argv)
    res = readings(args.workload, args.seeds, args.variants,
                   units=args.units)
    print(json.dumps(res))


if __name__ == "__main__":
    sys.exit(main())
