"""Milliseconds an optimizer step: the span around each unit's fit call
(``fit_frames_batched``, or ``fit_scan`` with its body and SMPL+D
steps) over the unit's ``opt_steps``, over the window."""


def read(run):
    recs = run["records"]
    spent = sum(b - a for r in recs for n, a, b in r["spans"] if n == "fit")
    return 1e3 * spent / sum(r["opt_steps"] for r in recs)
