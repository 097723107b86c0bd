"""Micro-benchmark entry points of the port: the Hopper counterparts of
the reference's ``experiments/`` scripts (run each with ``python -m``)."""
