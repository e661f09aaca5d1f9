"""Seconds a scan in ``build_observations`` (keypoints and the scan's
distance volume): the span around each unit's call, over the window's
scans."""


def read(run):
    recs = run["records"]
    return sum(b - a for r in recs for n, a, b in r["spans"]
               if n == "observations") / len(recs)
