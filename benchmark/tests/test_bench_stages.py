"""``stages.py``: device operations and idle gaps laid over the program's
spans on synthetic events (correlation ids, threads, a gap's middle,
events outside any span); the window's span readers on a registry filled
by hand; and, on the card, the shared clock."""

import time
import types

import pytest
import torch

from benchmark import harness, stages
from shimmer_tpu_torch import utils
from shimmer_tpu_torch.utils import stats
from shimmer_tpu_torch.utils.stats import SpanRecord

MAIN, OTHER = (7 << 32) | 0x9000_0001, 0x0000_0002   # threading.get_ident()
K_MAIN, K_OTHER = stages.thread_key(MAIN), stages.thread_key(OTHER)

RECORDS = [
    SpanRecord(0, "render/wave", 0, 1000, -1, MAIN),
    SpanRecord(1, "wavefront/wave", 10, 990, 0, MAIN),
    SpanRecord(2, "wavefront/regen", 20, 300, 1, MAIN),
    SpanRecord(3, "sampler/draw", 30, 100, 2, MAIN),
    SpanRecord(4, "wavefront/trace", 310, 600, 1, MAIN),
    SpanRecord(5, "traverse/launch", 320, 400, 4, MAIN),
    SpanRecord(6, "replay/backward", 0, 1000, -1, OTHER),
]
# (start, end, correlation, thread key) of the runtime calls.
LAUNCHES = [(40, 45, 1, K_MAIN), (200, 205, 2, K_MAIN), (350, 355, 3, K_MAIN),
            (350, 352, 4, K_OTHER), (995, 997, 5, K_MAIN), (2000, 2003, 6, K_MAIN)]
OPS = [(100, 150, 1, "k"), (250, 260, 2, "k"), (262, 270, 3, "k"), (500, 510, 4, "k"),
       (520, 530, 5, "k"), (3000, 3010, 6, "k"), (3020, 3030, 7, "memset")]


def test_thread_key_is_the_low_32_bits_signed():
    assert stages.thread_key(0x0000_0001_7FFF_FFFF) == 0x7FFF_FFFF
    assert stages.thread_key(0x0000_0001_8000_0000) == -(1 << 31)
    assert stages.thread_key(140437762630400) == 921985792


def test_operations_go_to_the_innermost_span_of_their_launch():
    a = stages.attribute(OPS, LAUNCHES, RECORDS)
    ns = 1e-9
    assert a["ops_s"] == pytest.approx(108 * ns)
    # Correlation 4 launched at 350 like correlation 3, on the other thread.
    assert a["busy_by_span"] == pytest.approx({
        "sampler/draw": 50 * ns, "wavefront/regen": 10 * ns, "traverse/launch": 8 * ns,
        "replay/backward": 10 * ns, "render/wave": 10 * ns, stages.OUTSIDE: 20 * ns})
    assert a["busy_by_stage"] == pytest.approx({
        "wavefront/regen": 60 * ns, "wavefront/trace": 8 * ns, stages.OUTSIDE: 40 * ns})
    assert a["busy_by_layer"] == pytest.approx({
        "sampler": 50 * ns, "wavefront": 68 * ns, "render": 78 * ns, "traverse": 8 * ns,
        "replay": 10 * ns})
    assert a["stage_busy_pct"] == pytest.approx(100 * 68 / 108)
    # Correlation 6 was launched outside any span; correlation 7 has no call.
    assert a["launches_outside"] == 1 and a["max_overhang_ns"] == 0
    assert a["busy_s"] == pytest.approx(108 * ns)
    text = stages.report(dict(a, iters=2.0, window_s=1e-6, spans=len(RECORDS)))
    assert "2 iterations, 7 spans" in text and "  sampler/draw " in text
    assert a["busy_by_layer_op"]["sampler"] == pytest.approx({"k": 50 * ns})
    assert "device operations under sampler/*" in text


def test_idle_gaps_go_to_the_span_at_their_middle_on_the_launching_thread():
    a = stages.attribute(OPS, LAUNCHES, RECORDS)
    ns = 1e-9
    # (150, 250) and (260, 262): regen at 200 and 261; (270, 500): the other
    # thread's span at 385, not traverse/launch; (510, 520): past
    # traverse/launch's end, so its parent; (530, 3000) and (3010, 3020)
    # outside any span.
    assert a["idle_by_span"] == pytest.approx({
        "wavefront/regen": 102 * ns, "replay/backward": 230 * ns, "wavefront/trace": 10 * ns,
        stages.OUTSIDE: 2480 * ns})
    assert a["idle_by_stage"] == pytest.approx({
        "wavefront/regen": 102 * ns, "wavefront/trace": 10 * ns, stages.OUTSIDE: 2710 * ns})
    assert a["idle_s"] == pytest.approx(2822 * ns)
    assert a["idle_in_span_pct"] == pytest.approx(100 * 342 / 2822)


def test_no_stages_off_the_card_or_without_spans(monkeypatch):
    run = types.SimpleNamespace(data={}, device=torch.device("cpu"), port=object(),
                                traffic={"kind": "frames"})
    assert stages.stages(run) is None and run.data["stages"] is None
    assert harness.reader("sampler_device_pct")(run) is None
    assert harness.reader("material_device_pct")(run) is None
    # A program whose registry has no spans: every reader finds nothing.
    monkeypatch.setattr(utils, "stats", types.SimpleNamespace(as_dict=dict))
    run = types.SimpleNamespace(data={}, device=torch.device("cuda"), port=object(),
                                traffic={"kind": "grad_steps", "pixel_block": 64},
                                config={"resolution": [16, 9]})
    for name in ("sampler_device_pct", "material_device_pct", "material_host_ms_per_iter",
                 "sync_wait_ms_per_iter", "grad_remat_ms", "grad_vjp_ms"):
        assert harness.reader(name)(run) is None, name


def _timed(name, ns=200_000):
    with stats.span(name):
        t = time.perf_counter_ns()
        while time.perf_counter_ns() - t < ns:
            pass


def test_window_readers_on_a_registry_filled_by_hand():
    stats.clear()
    try:
        _timed("material/eval")                    # outside render/wave: not read
        with stats.span("render/wave"):
            with stats.span("wavefront/wave"):
                with stats.span("material/sample"):
                    _timed("material/diffuse")
                _timed("wavefront/sync")
                _timed("wavefront/sync")
        stats.counter("Integrator/Wavefront iterations").add(2)
        recs = {r.name: r for r in stats.spans()}
        dur = lambda r: (r.end_ns - r.start_ns) * 1e-6
        syncs = [dur(r) for r in stats.spans() if r.name == "wavefront/sync"]
        run = types.SimpleNamespace()
        got = harness.reader("material_host_ms_per_iter")(run)
        assert got == pytest.approx(dur(recs["material/sample"]) / 2)
        assert harness.reader("sync_wait_ms_per_iter")(run) == pytest.approx(sum(syncs) / 2)
    finally:
        stats.clear()


def test_grad_readers_take_the_median_times_the_blocks():
    stats.clear()
    try:
        for ns in (100_000, 300_000, 5_000_000):
            _timed("replay/remat", ns)
        _timed("replay/vjp")
        remat = sorted(r.end_ns - r.start_ns for r in stats.spans() if r.name == "replay/remat")
        run = types.SimpleNamespace(traffic={"kind": "grad_steps", "pixel_block": 64},
                                    config={"resolution": [16, 9]})
        # 144 pixels in 64-pixel blocks: three blocks a step.
        assert harness.reader("grad_remat_ms")(run) == pytest.approx(remat[1] * 1e-6 * 3)
        assert harness.reader("grad_vjp_ms")(run) > 0
        run.traffic = {"kind": "frames"}
        assert harness.reader("grad_remat_ms")(run) is None
    finally:
        stats.clear()


@pytest.mark.card
def test_spans_and_the_device_trace_share_a_clock(card):
    """Each span launches two kernels, and spans are 200 us apart, so the
    i-th pair of runtime launches is the i-th span's: each lies inside its
    span to within 50 us (the largest offset is printed), and the
    attribution puts every kernel in its span."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1 << 20, device=card)
    x.add_(1)
    torch.cuda.synchronize()
    stats.clear()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(100):
                with stats.span("clock/launch"):
                    x.add_(1)
                    x.mul_(1.0001)
                t = time.perf_counter_ns()
                while time.perf_counter_ns() - t < 200_000:
                    pass
            torch.cuda.synchronize()
        recs = [r for r in stats.spans() if r.name == "clock/launch"]
        ops, launches = stages.events(prof)
        calls = sorted(c for c in launches if c[2] in {o[2] for o in ops})
        assert len(calls) == 2 * len(recs) == 200
        lead = min(s - r.start_ns for i, r in enumerate(recs) for s, _, _, _ in
                   calls[2 * i:2 * i + 2])
        trail = min(r.end_ns - e for i, r in enumerate(recs) for _, e, _, _ in
                    calls[2 * i:2 * i + 2])
        print(f"clock: launches start {lead} ns or more after their span's start and end "
              f"{trail} ns or more before its end")
        assert lead >= -50_000 and trail >= -50_000
        a = stages.attribute(ops, launches, recs)
        assert a["busy_by_span"].keys() == {"clock/launch"}
    finally:
        stats.clear()
