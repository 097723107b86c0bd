"""Device kernels in the profiled block-wave over its loop iterations."""


def read(run):
    p = run.profile
    if not p or not p.get("iters") or not p.get("kernels"):
        return None
    return p["kernels"] / p["iters"]
