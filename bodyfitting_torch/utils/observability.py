"""Observability: loss traces and stage timing.

Counterpart of ``bodyfitting_tpu/utils/observability.py``:
:class:`LossTrace` appends each fitted frame's loss curve to a JSONL file
(``loss_trace.jsonl``); :class:`StageTimer` and :func:`timed` record wall
time per pipeline stage (``timing.json`` under ``--timing``);
:func:`profiler_trace` records a ``torch.profiler`` trace of a block.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Optional

import numpy as np


class LossTrace:
    """Append-only JSONL loss-curve log, one record per fitted frame."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def record(self, frame_id, losses, terms: Optional[dict] = None,
               every: int = 1):
        losses = np.asarray(losses, np.float64)
        rec = {
            "frame": frame_id,
            "num_iters": int(losses.shape[-1]),
            "loss_first": float(losses[..., 0]),
            "loss_last": float(losses[..., -1]),
            "losses": [float(x) for x in losses[::every]],
        }
        if terms:
            rec["terms"] = {k: float(np.asarray(v).reshape(-1)[-1])
                            for k, v in terms.items()}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def to_csv(self, csv_path: Optional[str] = None) -> str:
        csv_path = csv_path or self.path.replace(".jsonl", ".csv")
        with open(self.path) as f, open(csv_path, "w") as out:
            out.write("frame,iter,loss\n")
            for line in f:
                rec = json.loads(line)
                for i, v in enumerate(rec["losses"]):
                    out.write(f"{rec['frame']},{i},{v}\n")
        return csv_path


class StageTimer:
    """Accumulates wall time per named pipeline stage (thread-safe: the
    app's stages run on prep and writer threads)."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[name] = self.totals.get(name, 0.0) + dt
                self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> dict:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "calls": self.counts[name],
                "mean_s": round(self.totals[name] / self.counts[name], 4),
            }
            for name in self.totals
        }

    def dump(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)


@contextlib.contextmanager
def timed(name: str, log=print):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        log(f"[timing] {name}: {time.perf_counter() - t0:.3f}s")


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """Trace the block with ``torch.profiler`` (host, and the card's
    kernels when CUDA is available) and write it as a Chrome trace,
    ``log_dir/trace.json`` (open it in Perfetto or ``chrome://tracing``).
    Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
