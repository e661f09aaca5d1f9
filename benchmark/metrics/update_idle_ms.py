"""Device-idle milliseconds a step of the traced slice while the host is
inside the program's ``fit.update`` spans (``smplify.Adam.step``'s own
body: the bias corrections built on the host and copied to the card,
and the per-group update), over the slice's steps."""

from benchmark import program_spans


def read(run):
    return program_spans.idle_ms_per_step(run, "fit.update")
