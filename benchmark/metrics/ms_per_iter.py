"""Wall milliseconds of the traced window over its wavefront loop
iterations."""


def read(run):
    d = run.data
    if not d.get("iters"):
        return None
    return d["window_s"] * 1e3 / d["iters"]
