"""Device-idle milliseconds a step of the traced slice while the host is
inside the program's ``fit.grad`` spans (``smplify.make_step_fn``:
``torch.autograd.grad`` and the zero-fill of unused leaves; the calling
thread waits there while the autograd engine's thread issues the
backward), over the slice's steps."""

from benchmark import program_spans


def read(run):
    return program_spans.idle_ms_per_step(run, "fit.grad")
