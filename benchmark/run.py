"""Run one cell of the benchmark of ``bodyfitting_torch`` on this
machine's CUDA card and print its result as the last line of standard
output.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout.  Set-up makes the cell's model, prior and
input pool from ``--seed``, loads them through the program's readers and
runs every shape once; the window then runs units back to back for
``--seconds``; ``--trace 1`` then runs one more unit with its
observations and a slice of its steps around the gate profiled, and
reports the per-layer metrics in place of the end-to-end ones.  After
the window the plain reference checks what the window produced.
Without a card, or with fewer cards than the cell asks for, it prints
no result and exits with 2.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(CACHE, sub)
# One CPU thread through the environment, as torchrun starts a worker:
# under PyTorch's own count (8 on an 8-core host) the fits ran slower and
# their runs spread too widely to hold a bound (PERF.md).  A program that
# sets its own count (torch.set_num_threads) still overrides it.
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path.insert(0, ROOT)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def trace_summary(rec):
    """The traced unit's device slice: busy and window seconds, the
    top device operations and the longest idle gaps."""
    from benchmark import harness

    t = rec["trace"]
    dev, host, extent = harness.read_trace(t["steps"])
    obs_dev, _, _ = harness.read_trace(t["observations"])
    t.update(device=dev, host=host, extent=extent, obs_device=obs_dev,
             n_steps=t["slice"][1] - t["slice"][0])
    busy = harness.union_us(dev) * 1e-6
    return (dict(busy_s=busy, window_s=(extent[1] - extent[0]) * 1e-6),
            dict(device_ops=harness.top_device_ops(dev),
                 idle_gaps=harness.idle_gaps(dev, host, extent)))


def main(argv=None, device="cuda", root=None, bench_json=None):
    """Run the cell; ``device``, ``root`` (the benchmark's directory) and
    ``bench_json`` are for tests, which drive a run on the CPU."""
    args = parse(argv)
    import torch

    from benchmark import counts, harness

    root = root or harness.HERE
    cell = harness.cell(args.workload, root=root, bench_json=bench_json)
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count()
                             < cell["entry"]["chips"]):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell['entry']['chips']} CUDA "
              f"card(s); this machine has {have}: no result",
              file=sys.stderr)
        return 2
    driver = cell["driver"]
    workdir = tempfile.mkdtemp(prefix=f"bench_{args.workload}_")
    try:
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        spans = harness.Spans(device)
        state = driver.setup(cell, args.seed, device, workdir, spans)
        harness.sync(device)
        setup_s = time.perf_counter() - T_START
        records, window_s = harness.window(driver, state, args.seconds)
        traced = []
        t_traced = time.perf_counter()
        if args.trace:
            # one more unit after the window, profiled: the window's own
            # units run without the profiler, whose hooks slow a process
            traced = [driver.traced_unit(state, len(records), workdir)]
        t_traced = time.perf_counter() - t_traced
        peak = (torch.cuda.max_memory_allocated() if device == "cuda"
                else 0)
        dev_info = dict(platform="gpu" if device == "cuda" else "cpu",
                        kind=(torch.cuda.get_device_name() if device == "cuda"
                              else "cpu"),
                        count=cell["entry"]["chips"], memory_peak_bytes=peak)
        breakdown = None
        t_read = time.perf_counter()
        if args.trace:
            extra, breakdown = trace_summary(traced[0])
            dev_info.update(extra)
        run = dict(cell=cell, state=state, records=records,
                   window_s=window_s, setup_s=setup_s,
                   trace=traced[0]["trace"] if traced else None,
                   traced=traced)
        wanted = cell["per_layer"] if args.trace else cell["end_to_end"]
        metrics = {}
        for m in wanted:
            value = harness.load_module("metrics", m["name"], root).read(run)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
        t_read = time.perf_counter() - t_read
        driver.release(records + traced)
        if device == "cuda":
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        checks = driver.check(state, records + traced)
        t_check = time.perf_counter() - t_check
        found = harness.forbidden_modules()
        if found:
            print(f"modules of JAX or the JAX package are loaded: {found}: "
                  f"no result", file=sys.stderr)
            return 3
        correct = all(math.isfinite(v) and v <= lim for _, v, lim in checks)
        result = dict(correct=correct, attempted=len(records + traced),
                      failed=0, metrics=metrics, device=dev_info)
        if breakdown is not None:
            result["breakdown"] = breakdown
        print("units (span seconds): " + "; ".join(
            ", ".join(f"{n} {b - a:.3f}" for n, a, b in r["spans"])
            for r in records), file=sys.stderr)
        print(f"{len(records)} units, {torch.get_num_threads()} CPU "
              f"threads, peak {peak} B; card {counts.power_limit()}",
              file=sys.stderr)
        print(f"phases (s): setup {setup_s:.3f}, window {window_s:.3f}, "
              f"traced unit {t_traced:.3f}, trace reading {t_read:.3f}, "
              f"reference {t_check:.3f}, process "
              f"{time.perf_counter() - T_START:.3f}", file=sys.stderr)
        harness.emit(result, checks)
        return 0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
