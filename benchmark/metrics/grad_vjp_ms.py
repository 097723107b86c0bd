"""Host milliseconds a step of the replay backward's autograd pass over
the replayed megakernel: the median ``replay/vjp`` span (its
``torch.autograd.grad``) times the pixel blocks of a step."""

from benchmark import stages


def read(run):
    return stages.grad_ms(run, "replay/vjp")
