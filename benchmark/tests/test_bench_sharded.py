"""The ``sharded_frames`` loop on the CPU: a gloo world of two ranks, two
bands of a 16x8 frame, a short window.  A sound run gives
``msamples_per_s`` and is correct; a run whose bands are gathered out of
rank order, whose rank renders with the wrong frame seed, or whose last
band is lost in the gather is not; a rank killed inside the window makes
the run exit non-zero within its timeout and leaves no process behind."""

import contextlib
import io
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
from conftest import tiny_run

from benchmark import harness

CELL = "diffuse-720p-4gpu.bands"
ROOT = Path(__file__).resolve().parents[2]


def two_band_run(seconds: float = 6.0, trace: bool = False):
    run = tiny_run(CELL, trace=trace, seconds=seconds)
    run.config["resolution"] = [16, 8]
    run.config["deployment"] = dict(run.config["deployment"], processes=2)
    run.traffic.update(spp=4, wave_spp=2)
    return run


@pytest.mark.parametrize("trace", [False, True])
def test_two_ranks_give_a_correct_rate(trace):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        line = harness.execute(two_band_run(trace=trace))
    assert line["correct"] is True and line["attempted"] >= 1 and line["failed"] == 0
    assert line["compared"]["off_pixels_pct"]["value"] == 0.0
    if trace:
        # The host-clock metric reads on the CPU; the device trace's does not.
        assert line["metrics"]["band_imbalance_pct"]["value"] > 0
        assert "gather_ms" not in line["metrics"]
    else:
        assert line["metrics"]["msamples_per_s"]["value"] > 0
    assert "sampled pixels by band [64, 64]" in err.getvalue()


def _out_of_order(monkeypatch):
    """Rank 0's gather puts the bands in the reverse of rank order."""
    import torch.distributed as dist

    real = dist.all_gather

    def all_gather(parts, tensor, *a, **k):
        out = real(parts, tensor, *a, **k)
        parts.reverse()
        return out

    monkeypatch.setattr(dist, "all_gather", all_gather)


def _wrong_seed(monkeypatch):
    """Rank 0 renders its band with the next frame's seed."""
    import copy

    from shimmer_tpu_torch.parallel import distributed

    real = distributed.render_sharded

    def render_sharded(scene, camera, film, sampler, *a, **k):
        sampler = copy.copy(sampler)
        sampler.seed += 1
        return real(scene, camera, film, sampler, *a, **k)

    monkeypatch.setattr(distributed, "render_sharded", render_sharded)


def _band_lost(monkeypatch):
    """The last rank's band never reaches rank 0: its part stays zero."""
    import torch.distributed as dist

    real = dist.all_gather

    def all_gather(parts, tensor, *a, **k):
        out = real(parts, tensor, *a, **k)
        parts[-1].zero_()
        return out

    monkeypatch.setattr(dist, "all_gather", all_gather)


@pytest.mark.parametrize("fault", [_out_of_order, _wrong_seed, _band_lost],
                         ids=["out_of_order", "wrong_seed", "band_lost"])
def test_broken_bands_are_not_correct(fault, monkeypatch):
    run = two_band_run()
    fault(monkeypatch)
    line = harness.execute(run)
    assert line["correct"] is False, line["compared"]


KILLED = f"""
import sys
sys.path.insert(0, {str(ROOT / 'benchmark' / 'tests')!r})
sys.path.insert(0, {str(ROOT)!r})
from test_bench_sharded import two_band_run
from benchmark import harness

if __name__ == "__main__":
    harness.execute(two_band_run(seconds=120.0))
    print("RESULT", flush=True)
"""


def _children(pid: int) -> list[int]:
    out = []
    for task in Path(f"/proc/{pid}/task").glob("*"):
        try:
            out += [int(c) for c in (task / "children").read_text().split()]
        except OSError:
            pass
    return out


def _alive(pid: int) -> bool:
    try:
        stat = Path(f"/proc/{pid}/stat").read_text()
    except OSError:
        return False
    return stat.rsplit(")", 1)[1].split()[0] != "Z"


def _cmdline(pid: int) -> str:
    try:
        return Path(f"/proc/{pid}/cmdline").read_bytes().replace(b"\0", b" ").decode()
    except OSError:
        return ""


def test_a_killed_rank_ends_the_run(tmp_path):
    script = tmp_path / "killed.py"
    script.write_text(KILLED)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, str(script)], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        for line in proc.stderr:
            if "the window opens" in line:
                break
        else:
            pytest.fail(f"the run ended before its window: rc {proc.wait(10)}")
        ranks = [p for p in _children(proc.pid) if "spawn_main" in _cmdline(p)
                 and "resource_tracker" not in _cmdline(p)]
        assert len(ranks) == 1, [_cmdline(p) for p in _children(proc.pid)]
        spawned = _children(proc.pid) + _children(ranks[0])
        t = time.monotonic()
        os.kill(ranks[0], signal.SIGKILL)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode != 0 and time.monotonic() - t < 30
        assert "RESULT" not in out
        deadline = time.monotonic() + 20
        while any(_alive(p) for p in spawned) and time.monotonic() < deadline:
            time.sleep(0.2)
        assert not [p for p in spawned if _alive(p)]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
