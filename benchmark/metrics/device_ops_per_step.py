"""Device kernels, copies and sets a step in the traced slice."""


def read(run):
    t = run["trace"]
    if not t or not t["device"]:
        return None
    return len(t["device"]) / t["n_steps"]
