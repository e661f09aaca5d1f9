"""Device-idle milliseconds a step of the traced slice while the host is
inside the program's ``fit.loss`` spans (``smplify.make_step_fn``: the
keypoint, prior and silhouette or SDF terms and the body forward): the
slice's idle stretches, as ``device_idle_pct`` counts them, that fall
inside those spans, over the slice's steps."""

from benchmark import program_spans


def read(run):
    return program_spans.idle_ms_per_step(run, "fit.loss")
