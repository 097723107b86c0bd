"""The device trace of a profiled sub-window: torch.profiler's CUDA
activity (device operations and the CUDA runtime calls that launched
them) read back in memory into the device's busy time, its kernels by
name, and the idle gaps by the runtime call the host was in at each
gap's middle ("(host code)" where it was in none: Python and torch's
dispatch between calls).  Host operator events are not recorded: a
sub-window of the material scene launches several hundred thousand
kernels, and recording the operators around them as well would cost
minutes to read back."""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

TOP = 10


def profiled(fn):
    """Run ``fn()`` under torch.profiler's CUDA activity, ending in a
    synchronize.  Returns (fn's result, :func:`summarize` of the trace)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        span = (e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9, e.name())
        (dev if e.device_type() == torch.autograd.DeviceType.CUDA else host).append(span)
    return out, summarize(dev, host, window_s)


def busy_intervals(spans):
    """The union of (start, end) spans, sorted and merged."""
    merged = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(dev, host, window_s: float) -> dict:
    """From device spans and host spans, each (start s, end s, name):
    the device's busy seconds (the union of its operations), its kernel
    count (spans whose name is not a memory copy or set), the device
    operations that took most time, and the idle gaps between device
    operations summed by the innermost host span covering each gap's
    middle."""
    busy = busy_intervals((s, e) for s, e, _ in dev)
    by_name = defaultdict(float)
    for s, e, name in dev:
        by_name[name] += e - s
    host = sorted(host)
    starts = [h[0] for h in host]
    gaps = defaultdict(float)
    for (_, end), (nxt, _) in zip(busy, busy[1:]):
        mid = 0.5 * (end + nxt)
        i = bisect.bisect_right(starts, mid) - 1
        name = "(host code)"
        # The latest-starting span that still covers the middle is the innermost.
        for j in range(i, max(i - 64, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        gaps[name] += nxt - end
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {
        "window_s": window_s,
        "busy_s": sum(e - s for s, e in busy),
        "kernels": sum(1 for _, _, n in dev if not n.startswith("Memcpy")
                       and not n.startswith("Memset")),
        "device_ops": top(by_name),
        "idle_gaps": top(gaps),
    }
