"""Host milliseconds a step of the replay backward's forward pass, the
megakernel replayed under autograd: the median ``replay/remat`` span
times the pixel blocks of a step.  A median, since the registry holds
every step of the run (the followed steps and the profiled one too)."""

from benchmark import stages


def read(run):
    return stages.grad_ms(run, "replay/remat")
