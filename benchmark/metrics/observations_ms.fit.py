"""Milliseconds a frame in ``build_observations`` (keypoints, contours,
crops, the upload): the benchmark's host-clock span around each unit's
calls, closed after the device drained, over the window's frames."""


def read(run):
    recs = run["records"]
    spent = sum(b - a for r in recs for n, a, b in r["spans"]
                if n == "observations")
    return 1e3 * spent / sum(len(r["frames"]) for r in recs)
