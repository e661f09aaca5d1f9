"""The whole step's share of the H100's float32 peak: each unit's
operations (its ``ops``, from the configuration's shapes by
``counts.py``) over the seconds in its fit call, over the window."""

from benchmark import counts


def read(run):
    recs = run["records"]
    spent = sum(b - a for r in recs for n, a, b in r["spans"] if n == "fit")
    return 100.0 * sum(r["ops"] for r in recs) / spent \
        / counts.F32_FLOPS_PER_S
