"""The device's idle share of the profiled block-wave, in percent: one
less the union of its device operations over its wall window."""


def read(run):
    p = run.profile
    if not p or run.traffic["kind"] != "frames" or not p.get("busy_s"):
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
