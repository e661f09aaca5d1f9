"""The program's own spans in a traced run, and the device's idle time
while the host is inside them.

``bodyfitting_torch.utils.observability.span`` writes each span into the
profiler's Chrome trace as a ``user_annotation`` event, on the clock of
the card's kernels, so ``harness.read_trace`` keeps it among the host
spans.  The fit's spans (``fit.loss``, ``fit.grad``, ``fit.update``) are
read from the traced slice of steps; ``observations.contours`` from the
trace of the traced unit's ``build_observations``.  Where a trace holds
no span of the name (a program without spans) or no device event (a run
on the CPU, for the idle time), a reader returns ``None``: a missing
span never reads as nought.
"""

from __future__ import annotations

import functools
import os

from benchmark import harness


def intervals(spans, name=None):
    """The union of ``spans`` (``(name, start, end)``; those named
    ``name`` alone, if given) as sorted disjoint ``(start, end)``."""
    out = []
    for _, a, b in sorted((s for s in spans if name is None or s[0] == name),
                          key=lambda s: s[1]):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        elif b > a:
            out.append((a, b))
    return out


def idle(dev, extent):
    """The stretches of ``extent`` that no device event covers, as
    ``device_idle_pct`` counts them."""
    out, end = [], extent[0]
    for a, b in intervals(dev):
        if a > end:
            out.append((end, a))
        end = max(end, b)
    if extent[1] > end:
        out.append((end, extent[1]))
    return out


def overlap_us(xs, ys):
    """Microseconds in both of two sorted disjoint interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_inside_us(dev, host, extent, name):
    """Device-idle microseconds of ``extent`` while the host is inside a
    span named ``name``; ``None`` with no device event or no such span."""
    inside = intervals(host, name)
    if not dev or not inside:
        return None
    lo, hi = extent
    inside = [(max(a, lo), min(b, hi)) for a, b in inside
              if min(b, hi) > max(a, lo)]
    return overlap_us(idle(dev, extent), inside)


def idle_ms_per_step(run, name):
    """Device-idle milliseconds a step of the traced slice while the host
    is inside the program's ``name`` spans."""
    t = run["trace"]
    if not t:
        return None
    us = idle_inside_us(t["device"], t["host"], t["extent"], name)
    return None if us is None else 1e-3 * us / t["n_steps"]


@functools.lru_cache(maxsize=1)
def _read(path, mtime_ns):
    return harness.read_trace(path)


def observation_spans(run, name):
    """The spans named ``name`` in the trace of the traced unit's
    ``build_observations`` (parsed once a run, however many metrics read
    it); ``None`` where it holds none."""
    t = run["trace"]
    if not t:
        return None
    path = t["observations"]
    _, host, _ = _read(path, os.stat(path).st_mtime_ns)
    return [s for s in host if s[0] == name] or None
