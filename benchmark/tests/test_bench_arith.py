"""The yardstick's bound, the trace's busy and idle arithmetic, the metric
readers and the check's numbers, on fixed inputs."""

import types

import pytest
import torch

from benchmark import compare, harness, trace, yardstick


def test_bound_by_operations():
    b = yardstick.bound(visits=1_000_000, internal_rows=10, leaf_rows=20, rays=100)
    want_bytes = 10 * 224 + 20 * 288 + 100 * 37
    assert b["bytes"] == want_bytes
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(1_000_000 * 208 / 67e12 * 1e3)


def test_bound_by_bytes():
    b = yardstick.bound(visits=1, internal_rows=1_000_000, leaf_rows=0, rays=0)
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(224e6 / 3.35e12 * 1e3)


def test_busy_is_the_union_of_device_spans():
    assert trace.busy_intervals([(3.0, 4.0), (0.0, 1.0), (0.5, 2.0), (4.0, 4.5)]) == [
        [0.0, 2.0], [3.0, 4.5]]


def test_summarize_idle_gaps_by_innermost_host_span():
    dev = [(0.0, 1.0, "k1"), (0.5, 2.0, "k2"), (3.0, 4.0, "k1"), (6.0, 7.0, "Memcpy HtoD")]
    host = [(2.0, 3.0, "cudaLaunchKernel"), (2.2, 2.8, "cudaStreamSynchronize")]
    s = trace.summarize(dev, host, window_s=8.0)
    assert s["busy_s"] == pytest.approx(4.0)
    assert s["kernels"] == 3
    assert s["device_ops"][0] == ["k1", pytest.approx(2.0)]
    # Gap (2, 3) has its middle in the synchronize; gap (4, 6) in no host span.
    assert dict((k, v) for k, v in s["idle_gaps"]) == {
        "cudaStreamSynchronize": pytest.approx(1.0), "(host code)": pytest.approx(2.0)}
    idle = harness.reader("device_idle_pct.render")(types.SimpleNamespace(
        profile=s, traffic={"kind": "frames"}))
    assert idle == pytest.approx(50.0)


def _run(**data):
    return types.SimpleNamespace(data=data, profile={"kernels": 4800, "iters": 12.0},
                                 traffic={"kind": "frames"})


def test_readers_on_fixed_counts():
    run = _run(iters=100.0, samples=3_686_400, rays=13_107_200.0, lanes=131_072,
               window_s=6.5)
    assert harness.reader("iters_per_msample")(run) == pytest.approx(100 / 3.6864)
    assert harness.reader("ms_per_iter")(run) == pytest.approx(65.0)
    assert harness.reader("lane_occupancy")(run) == pytest.approx(50.0)
    assert harness.reader("launches_per_iter")(run) == pytest.approx(400.0)


def test_readers_find_nothing_without_counts():
    run = _run()
    run.profile = None
    for name in ("iters_per_msample", "ms_per_iter", "lane_occupancy", "launches_per_iter",
                 "device_idle_pct.render", "device_idle_pct.grad", "grad_bwd_ms",
                 "grad_peak_gb"):
        assert harness.reader(name)(run) is None, name


def test_off_pixels():
    want = torch.ones(4, 3)
    got = want.clone()
    got[0, 1] *= 1 + 2 * compare.REL_TOL
    got[1, 2] *= 1 + 0.5 * compare.REL_TOL
    numbers = compare.frames_numbers(got, want, {"off_pixels_pct": 10.0})
    assert numbers["off_pixels_pct"] == {"value": pytest.approx(25.0), "limit": 10.0}


def test_norm_gaps_by_worst_kept_row():
    want = torch.tensor([[3.0, 4.0, 0.0], [0.0, 0.0, 10.0], [0.0, 0.0, 1e-9]])
    got = torch.tensor([[3.0, 4.0, 0.0], [0.0, 0.0, 9.0], [0.0, 0.0, 5e-9]])
    keep = torch.tensor([True, True, False])
    # Row 1: |9 - 10| over max(10, median 5) = 0.1; row 2 is left out.
    assert compare.norm_gaps(got, want, keep) == pytest.approx(0.1)
    # Row 0 against the median row's norm where its own is smaller.
    keep = torch.tensor([True, False, False])
    got[0, 0] = 0.0
    assert compare.norm_gaps(got, want, keep) == pytest.approx(1.0 / 5.0)


def test_loss_gap_is_the_worst_step():
    rows = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
    ref = {"losses": [10.0, 8.0, 6.0], "grad": rows, "change": rows, "before": rows}
    got = dict(ref, losses=[10.0, 8.4, 6.0])
    limit = {"loss_gap": 0.01, "grad_gap": 0.0, "change_gap": 0.0}
    numbers = compare.grad_numbers(got, ref, limit)
    assert numbers["loss_gap"]["value"] == pytest.approx(0.05)
    assert numbers["grad_gap"]["value"] == 0.0 and numbers["change_gap"]["value"] == 0.0
    with pytest.raises(ValueError):
        compare.grad_numbers(dict(ref, losses=[10.0]), ref, limit)
