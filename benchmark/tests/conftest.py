"""CPU tests of the benchmark: ``python -m pytest benchmark/tests``.  Tests
marked ``card`` need a CUDA card and skip without one (on the card:
``python -m pytest benchmark/tests -m card``); whether there is one is
decided in the ``card`` fixture, when a test runs, never at import."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    return torch.device("cuda")


SEED = 3_000_000_019   # above 2**31, as the benchmark's seeds may be
TINY = {"resolution": (16, 9), "sphere_tris": 2000, "pixel_block": 64}


def tiny_run(workload: str, trace: bool = False, seconds: float | None = None, bench=None,
             root=None, seed: int = SEED):
    """A run of ``workload`` on the CPU at a tiny size: 16x9 pixels, a
    2,000-triangle sphere, 64-lane pixel blocks, and the frames loop at 2
    spp in 1-spp waves.  The window is long enough for the first frame's
    first wave: the material scene's iterations launch many more
    operations.  Returns the
    Run, ready for ``harness.execute``."""
    import time

    from benchmark import harness

    bench = harness.load_bench() if bench is None else bench
    root = harness.ROOT if root is None else root
    cell, config, traffic = harness.load_cell(bench, workload, root)
    config["geometry"]["sphere_tris"] = TINY["sphere_tris"]
    config["resolution"] = TINY["resolution"]
    traffic = dict(traffic, pixel_block=TINY["pixel_block"])
    if traffic["kind"] == "frames":
        traffic.update(spp=2, wave_spp=1)
    if seconds is None:
        seconds = 12.0 if len(config["materials"]) > 3 else 6.0
    run = harness.Run(bench, cell, config, traffic, seed, seconds, trace, time.perf_counter(),
                      device="cpu")
    run.root = root
    return run
