"""The distance volume's share of its roofline: the least traffic of
its nearest-point queries (every cell centre, triangle and vertex read
once, each cell's distance and face written once; ``counts.volume_bytes``)
at the H100's bandwidth, over all device time of the traced unit's
``build_observations``."""

from benchmark import counts


def read(run):
    t = run["trace"]
    if not t:
        return None
    spent = sum(b - a for _, a, b in t["obs_device"]) * 1e-6
    if spent <= 0:
        return None
    bound = counts.volume_bytes(run["cell"]["config"]) / counts.HBM_BYTES_PER_S
    return 100.0 * bound / spent
