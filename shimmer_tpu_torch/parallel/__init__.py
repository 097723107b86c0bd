"""Multi-GPU rendering (port of ``shimmer_tpu/parallel``): row-band and
spp sharding over several devices in one process (``render.py``), and
across processes with ``torch.distributed`` (``distributed.py``)."""
