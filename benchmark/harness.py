"""What every cell shares: finding a cell's files by name, the closed-loop
window, the spans around each call, the device trace of a bounded slice,
and the result line.

Nothing here knows a configuration, a traffic mix or a metric by name:
``workloads/<cell>.json`` names its configuration and its driver,
``configs/<config>.json`` holds the sizes, ``drivers/<driver>.py`` runs
one kind of unit and decides ``correct``, and ``metrics/<metric>.py``
reads one metric off the run.  Each unit's record carries ``opt_steps``
(its optimizer steps) and ``ops`` (its operations by ``counts.py``), so
that one reader serves every kind of unit.  ``BENCHMARK.json`` lists which metrics a
cell reports.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "bodyfitting_tpu")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str, root: str = HERE):
    """``<root>/<kind>/<name>.py`` as a module (a name may hold dots); a
    name with no file of its own falls back to the file of the part
    before its first dot, so that ``step_ms.fit`` and ``step_ms.scan``,
    one quantity split by the metric it moves, share ``step_ms.py``."""
    path = os.path.join(root, kind, name + ".py")
    if not os.path.exists(path):
        path = os.path.join(root, kind, name.split(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(name: str, root: str = HERE, bench_json: str | None = None):
    """A cell's parts, found by name: its workload file, configuration
    file (with the workload's ``fit`` settings over its own), driver
    module, and the end-to-end and per-layer metric entries
    of ``BENCHMARK.json`` that it reports (a metric with no
    ``workloads`` list is reported by every cell that reports the metric
    it moves)."""
    bench = load_json(bench_json or os.path.join(os.path.dirname(root),
                                                 "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"unknown workload {name!r}")
    work = load_json(root, "workloads", name + ".json")
    config = load_json(root, "configs", work["config"] + ".json")
    # a workload's ``fit`` settings (the app's flags it runs with) over
    # the configuration's
    config["fit"] = dict(config["fit"], **work.get("fit", {}))
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in e2e_names
                              else [])]
    return dict(name=name, entry=entry, work=work, config=config,
                driver=load_module("drivers", work["driver"], root),
                end_to_end=e2e, per_layer=layer)


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Spans:
    """Host-clock spans, each closed after the device has drained."""

    def __init__(self, device):
        self.device, self.items = device, []

    def __call__(self, name, fn, *args, **kw):
        sync(self.device)
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        sync(self.device)
        self.items.append((name, t0, time.perf_counter()))
        return out


def window(driver, state, seconds):
    """Units back to back from index 0: a unit starts while the clock is
    under ``seconds``; the one in progress finishes.  Returns the
    records and the window (first start to last end)."""
    records = []
    start = time.perf_counter()
    while not records or time.perf_counter() - start < seconds:
        t0 = time.perf_counter()
        rec = driver.unit(state, len(records))
        rec.update(t0=t0, t1=time.perf_counter())
        records.append(rec)
    return records, records[-1]["t1"] - records[0]["t0"]


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# Device trace of a slice
# ---------------------------------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "python_function", "user_annotation")
NAME_CHARS = 160        # a kernel's template arguments run to kilobytes


def read_trace(path):
    """``(device [(name, start_us, end_us)], host [(name, start, end)],
    extent (start, end))`` of a Chrome trace written by torch.profiler."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        span = (e.get("name", "?")[:NAME_CHARS], float(e["ts"]),
                float(e["ts"]) + float(e["dur"]))
        if e.get("cat") in DEVICE_CATS:
            dev.append(span)
        elif e.get("cat") in HOST_CATS:
            host.append(span)
    spans = dev + host
    extent = (min(s for _, s, _ in spans), max(e for _, _, e in spans)) \
        if spans else (0.0, 0.0)
    return dev, host, extent


def union_us(spans):
    """Microseconds covered by at least one of ``spans``."""
    total, end = 0.0, -float("inf")
    for _, a, b in sorted(spans, key=lambda s: s[1]):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def idle_gaps(dev, host, extent, n=10):
    """The ``n`` longest stretches with no device activity, each named by
    the innermost host operation running at its middle."""
    gaps, end = [], extent[0]
    for _, a, b in sorted(dev, key=lambda s: s[1]):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if extent[1] > end:
        gaps.append((end, extent[1]))
    out = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
        mid = 0.5 * (a + b)
        around = [h for h in host if h[1] <= mid <= h[2]]
        name = min(around, key=lambda h: h[2] - h[1])[0] if around else "host"
        out.append([name, (b - a) * 1e-6])
    return out


def top_device_ops(dev, n=10):
    by = {}
    for name, a, b in dev:
        by[name] = by.get(name, 0.0) + (b - a) * 1e-6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def profile_to(path, device, schedule=None):
    """A torch.profiler over host and device whose trace goes to ``path``
    when it stops (at the end of ``schedule``'s active steps, if given)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts, schedule=schedule,
                   on_trace_ready=lambda p: p.export_chrome_trace(path))


# ---------------------------------------------------------------------------
# The result
# ---------------------------------------------------------------------------

def emit(result, checks):
    """Each compared number beside its limit, last on standard error, then
    the result as the last line of standard output, ``checks`` last."""
    for name, value, limit in checks:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in checks}
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
