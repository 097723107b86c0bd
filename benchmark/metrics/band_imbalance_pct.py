"""How far the slowest rank's row bands outlast the average rank's over
the counted frames of a ``sharded_frames`` run, in percent: 100 x (max_r
B_r / mean_r B_r - 1), B_r rank r's summed ``shard/band`` host time
(``loops/sharded_frames.py``).  None where the program records no such
span."""


def read(run):
    return run.data.get("band_imbalance_pct")
