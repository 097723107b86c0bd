"""Wavefront loop iterations per million pixel samples in the window
(the port's stats counter ``Integrator/Wavefront iterations``)."""


def read(run):
    d = run.data
    if not d.get("iters") or not d.get("samples"):
        return None
    return d["iters"] / (d["samples"] / 1e6)
