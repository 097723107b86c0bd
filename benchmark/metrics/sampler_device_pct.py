"""The share of device time, in percent, of one profiled block-wave's
operations launched inside a ``sampler/*`` span of the program (the
pixel sample's start and every draw: ZSobol's hashing), against all its
operations (``stages.py``)."""

from benchmark import stages


def read(run):
    a = stages.stages(run)
    if not a or not a["ops_s"]:
        return None
    return 100.0 * a["busy_by_layer"].get("sampler", 0.0) / a["ops_s"]
