"""Frames fitted a second: the frames of every unit of the window over
the window, first start to last end."""


def read(run):
    return sum(len(r["frames"]) for r in run["records"]) / run["window_s"]
