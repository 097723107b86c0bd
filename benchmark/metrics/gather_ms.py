"""The device time of the band gather of one traced frame of a
``sharded_frames`` run, in ms: the operations launched inside
``render_multihost``'s ``shard/gather`` span (the NCCL all_gather and the
concatenation), attributed by ``stages.attribute``; the smallest over the
ranks, since the last rank to arrive waits for nobody
(``loops/sharded_frames.py``).  None off the card, or where the program
records no such span."""


def read(run):
    return run.data.get("gather_ms")
