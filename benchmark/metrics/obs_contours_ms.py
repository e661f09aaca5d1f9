"""Milliseconds a frame in the program's ``observations.contours`` spans
(``body_fitting.build_observations``: the mask views' outer contours
traced and resampled on the host), summed over the profiled
``build_observations`` of the traced unit, over its frames."""

from benchmark import program_spans


def read(run):
    spans = program_spans.observation_spans(run, "observations.contours")
    if spans is None:
        return None
    return 1e-3 * sum(b - a for _, a, b in spans) \
        / len(run["traced"][0]["frames"])
