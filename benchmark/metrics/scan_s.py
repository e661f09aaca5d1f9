"""Seconds a scan: the window, first start to last end, over the scans
fitted in it."""


def read(run):
    return run["window_s"] / len(run["records"])
