"""The share of device time, in percent, of one profiled block-wave's
operations launched inside a ``material/*`` span of the program (the
BSDF dispatch: sample, pdf, eval, mix and the families below them),
against all its operations (``stages.py``)."""

from benchmark import stages


def read(run):
    a = stages.stages(run)
    if not a or not a["ops_s"]:
        return None
    return 100.0 * a["busy_by_layer"].get("material", 0.0) / a["ops_s"]
