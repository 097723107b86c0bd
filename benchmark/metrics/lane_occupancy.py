"""Traced rays (the port's ``Integrator/Rays traced``) over the lanes the
window's iterations offered: iterations x 2 (extension and shadow) x
lanes per block, in percent."""


def read(run):
    d = run.data
    if not d.get("iters") or not d.get("rays"):
        return None
    return 100.0 * d["rays"] / (d["iters"] * 2 * d["lanes"])
