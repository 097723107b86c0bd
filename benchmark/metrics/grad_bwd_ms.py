"""Milliseconds of ``loss.backward()`` per step over the window's steps
(the replay backward: each block's paths replayed through the megakernel
under autograd), each span ending in a synchronize."""


def read(run):
    return run.data.get("bwd_ms") or None
