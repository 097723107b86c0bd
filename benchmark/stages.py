"""The program's own spans (``shimmer_tpu_torch.utils.stats``) laid over
the device trace, and the window's spans read by layer.

Spans and torch.profiler's events share a clock (Unix nanoseconds), so:

- a device operation goes to the innermost span that encloses the CUDA
  runtime call that launched it, matched by correlation id and, for the
  thread, by the call's ``device_resource_id()`` (the low 32 bits, signed,
  of the launching thread's ``threading.get_ident()``, which a span
  records);
- an idle gap between the device's busy intervals goes to the innermost
  span, on the thread that launched the operation ending the gap, that
  covers the gap's middle.

:func:`stages` profiles one block-wave of a ``frames`` run, as
``loops/frames.py``'s ``block_wave`` runs it, under the CUDA activity
only (as ``trace.py`` does), once a run: the readers share it through
``run.data``.  It prints its tables to stderr and gives None off the
card, or where the program records no spans.

:func:`ms_per_iter` reads the spans of the window's waves, those under
``render/wave``: not the warm-up's (before the loop's ``stats.clear()``)
nor a profiled block-wave's (no ``render/wave``); :func:`grad_ms` the
replay's spans of every step.
"""

from __future__ import annotations

import bisect
import math
import statistics
import sys
import time
from collections import defaultdict

OUTSIDE = "(outside any span)"
WAVE = "wavefront/wave"


def _stats():
    """The program's stats module, or None where it records no spans."""
    from shimmer_tpu_torch.utils import stats

    return stats if hasattr(stats, "spans") else None


def thread_key(ident: int) -> int:
    """``threading.get_ident()`` as a runtime event's ``device_resource_id()``."""
    return ((ident & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000


def _paths(records):
    """For each record's index: (its innermost-first chain of names, the
    stage it lies in: the span right below ``wavefront/wave``, that span
    itself for its own time, else None).  A parent not among the records
    (still open, or before a clear) ends the chain."""
    by = {r.index: r for r in records}
    chains = {}
    for r in sorted(records):
        p = by.get(r.parent)
        chains[r.index] = (r.name,) + (chains[p.index] if p is not None else ())
    stage = {}
    for i, chain in chains.items():
        stage[i] = None
        if WAVE in chain:
            k = chain.index(WAVE)
            stage[i] = chain[k - 1] if k > 0 else WAVE
    return chains, stage


class _Enclosing:
    """The innermost record enclosing a time, one thread at a time."""

    def __init__(self, records):
        self.threads = defaultdict(list)
        for r in sorted(records, key=lambda r: (r.start_ns, r.index)):
            self.threads[thread_key(r.thread)].append(r)
        self.starts = {k: [r.start_ns for r in v] for k, v in self.threads.items()}
        self.by = {r.index: r for r in records}

    def at(self, key, t):
        recs = self.threads.get(key)
        if not recs:
            return None
        j = bisect.bisect_right(self.starts[key], t) - 1
        r = recs[j] if j >= 0 else None
        # Spans of a thread nest, so the innermost one that holds t is the
        # latest-starting one or an ancestor of it.
        while r is not None and r.end_ns < t:
            r = self.by.get(r.parent)
        return r


def attribute(ops, launches, records) -> dict:
    """Device time and idle gaps by span.

    ``ops``: device operations (start ns, end ns, correlation id, name);
    ``launches``: CUDA runtime calls (start ns, end ns, correlation id,
    thread key); ``records``: ``stats.spans()``.  Returns seconds by innermost span name, by stage
    below ``wavefront/wave`` and by layer (a name's part before ``/``;
    an operation counts once in each layer of its chain), the same for
    idle gaps, the totals, and how the launches sit in their spans."""
    chains, stage = _paths(records)
    enc = _Enclosing(records)
    call = {c: (s, e, k) for s, e, c, k in launches}
    busy_by = defaultdict(float)
    stage_by = defaultdict(float)
    layer_by = defaultdict(float)
    layer_ops = defaultdict(lambda: defaultdict(float))
    ops_s = 0.0
    outside_calls = 0
    overhang = 0
    owner = []   # (start, end, thread key of the launch) of each operation
    for s, e, corr, name in ops:
        dur = (e - s) * 1e-9
        ops_s += dur
        launch = call.get(corr)
        rec = enc.at(launch[2], launch[0]) if launch is not None else None
        owner.append((s, e, None if launch is None else launch[2]))
        if rec is None:
            busy_by[OUTSIDE] += dur
            stage_by[OUTSIDE] += dur
            outside_calls += launch is not None
            continue
        overhang = max(overhang, launch[1] - rec.end_ns)
        busy_by[rec.name] += dur
        stage_by[stage[rec.index] or OUTSIDE] += dur
        for layer in {span.split("/", 1)[0] for span in chains[rec.index]}:
            layer_by[layer] += dur
            layer_ops[layer][name] += dur
    # Busy intervals (the union), each with the launching thread of the
    # operation that opens it; idle gaps between them.
    owner.sort()
    merged = []
    for s, e, key in owner:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e, key])
    idle_by = defaultdict(float)
    idle_stage = defaultdict(float)
    for (_, end, _), (nxt, _, key) in zip(merged, merged[1:]):
        gap = (nxt - end) * 1e-9
        rec = enc.at(key, 0.5 * (end + nxt)) if key is not None else None
        idle_by[rec.name if rec is not None else OUTSIDE] += gap
        idle_stage[(stage[rec.index] or OUTSIDE) if rec is not None else OUTSIDE] += gap
    idle_s = sum(idle_by.values())
    return {
        "ops_s": ops_s,
        "busy_s": sum((e - s) * 1e-9 for s, e, _ in merged),
        "idle_s": idle_s,
        "busy_by_span": dict(busy_by),
        "busy_by_stage": dict(stage_by),
        "busy_by_layer": dict(layer_by),
        "busy_by_layer_op": {k: dict(v) for k, v in layer_ops.items()},
        "idle_by_span": dict(idle_by),
        "idle_by_stage": dict(idle_stage),
        "stage_busy_pct": 100.0 * sum(v for k, v in stage_by.items()
                                      if k not in (OUTSIDE, WAVE)) / ops_s if ops_s else 0.0,
        "idle_in_span_pct": 100.0 * (idle_s - idle_by.get(OUTSIDE, 0.0)) / idle_s
        if idle_s else 0.0,
        "launches_outside": outside_calls,
        "max_overhang_ns": overhang,
    }


def _table(title, d, total, top=None):
    lines = [f"stages: {title}"]
    for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]:
        lines.append(f"  {k:<36s} {v:12.6f} s {100.0 * v / total if total else 0.0:7.2f}%")
    return lines


def _short(kernel: str) -> str:
    """A kernel's name without its namespaces, cut to 110 characters."""
    for ns in ("void ", "at::native::", "(anonymous namespace)::", "at::"):
        kernel = kernel.replace(ns, "")
    return kernel[:110]


def report(a: dict) -> str:
    lines = [f"stages: one block-wave of {a['window_s']:.6f} s, {a['iters']:g} iterations, "
             f"{a['spans']} spans: device operations "
             f"{a['ops_s']:.6f} s (busy {a['busy_s']:.6f} s), idle gaps {a['idle_s']:.6f} s; "
             f"{a['stage_busy_pct']:.2f}% of device time in a stage below {WAVE}, "
             f"{a['idle_in_span_pct']:.2f}% of idle time inside a span; launches outside any "
             f"span {a['launches_outside']}, latest launch end past its span's "
             f"{a['max_overhang_ns']} ns"]
    lines += _table("device time by innermost span", a["busy_by_span"], a["ops_s"])
    lines += _table(f"device time by stage (below {WAVE})", a["busy_by_stage"], a["ops_s"])
    lines += _table("device time by layer (once in each layer of the chain)",
                    a["busy_by_layer"], a["ops_s"])
    for layer, by_op in sorted(a["busy_by_layer_op"].items()):
        if layer not in ("render", "wavefront"):
            short = defaultdict(float)
            for k, v in by_op.items():
                short[_short(k)] += v
            lines += _table(f"device operations under {layer}/*", short, a["ops_s"], top=8)
    lines += _table("idle gaps by innermost span at the middle", a["idle_by_span"],
                    a["idle_s"])
    lines += _table("idle gaps by stage", a["idle_by_stage"], a["idle_s"])
    return "\n".join(lines)


def events(prof):
    """(device operations, CUDA runtime calls) of a torch.profiler trace,
    as :func:`attribute` takes them."""
    import torch

    ops, launches = [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            ops.append((s, s + e.duration_ns(), e.correlation_id(), e.name()))
        elif e.name().startswith("cu"):
            launches.append((s, s + e.duration_ns(), e.correlation_id(),
                             e.device_resource_id()))
    return ops, launches


def _profile_block_wave(run, stats) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark import port
    from benchmark import scene as sc
    from shimmer_tpu_torch import render as rd

    t = run.traffic
    dev = run.device
    scene, cam, film = run.port
    res = film.resolution
    spp, wave_spp, block = int(t["spp"]), int(t["wave_spp"]), int(t["pixel_block"])
    smp = sc.sampler(sc.side(sc.PORT), run.config, res, run.seed + run.data.get("frames", 0),
                     spp)
    wave = rd.make_wavefront_renderer(scene, cam, film, smp,
                                      max_depth=int(run.config["integrator"]["maxdepth"]))
    blocks, valids = rd.pixel_blocks(film, block, dev)
    idx = torch.arange(wave_spp, dtype=torch.int64, device=dev)
    port.sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time_ns()
        state, st = wave(film.init_state(dev), idx, blocks[0], valids[0])
        film.get_image(state)
        port.sync(dev)
        t1 = time.time_ns()
    ops, launches = events(prof)
    records = [r for r in stats.spans() if t0 <= r.start_ns and r.end_ns <= t1]
    a = attribute(ops, launches, records)
    a.update(iters=float(st["iters"]), window_s=(t1 - t0) * 1e-9, spans=len(records))
    print(report(a), file=sys.stderr)
    return a


def stages(run) -> dict | None:
    """:func:`attribute` of one profiled block-wave of a ``frames`` run on
    the card, made once a run; None elsewhere."""
    if "stages" not in run.data:
        stats = _stats()
        ok = (stats is not None and run.device.type == "cuda" and run.port is not None
              and run.traffic.get("kind") == "frames")
        run.data["stages"] = _profile_block_wave(run, stats) if ok else None
    return run.data["stages"]


def ms_per_iter(pick) -> float | None:
    """Host milliseconds a wavefront iteration in the window's spans for
    which ``pick(record, chain)`` holds (the chain innermost first), over
    the registry's ``Integrator/Wavefront iterations``."""
    stats = _stats()
    if stats is None:
        return None
    iters = stats.as_dict().get("Integrator/Wavefront iterations", 0.0)
    records = stats.spans()
    chains, _ = _paths(records)
    ns = sum(r.end_ns - r.start_ns for r in records
             if "render/wave" in chains[r.index] and pick(r, chains[r.index]))
    if not iters or not ns:
        return None
    return ns * 1e-6 / iters


def grad_ms(run, name: str) -> float | None:
    """The median duration of the ``name`` spans, in ms, times the pixel
    blocks of a step."""
    stats = _stats()
    if stats is None or run.traffic.get("kind") != "grad_steps":
        return None
    durations = [r.end_ns - r.start_ns for r in stats.spans() if r.name == name]
    if not durations:
        return None
    w, h = run.config["resolution"]
    blocks = math.ceil(int(w) * int(h) / int(run.traffic["pixel_block"]))
    return statistics.median(durations) * 1e-6 * blocks
