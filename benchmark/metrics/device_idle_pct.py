"""The device's idle share of the traced slice of steps: one minus the
union of its kernels, copies and sets over the slice's extent."""

from benchmark import harness


def read(run):
    t = run["trace"]
    if not t or not t["device"]:
        return None
    a, b = t["extent"]
    return 100.0 * (1.0 - harness.union_us(t["device"]) / (b - a))
