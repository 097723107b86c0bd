"""Render-statistics registry (port of ``shimmer_tpu/utils/stats.py``, an
analogue of pbrt's stats system), with nested spans on the profiler's
clock.

Counters and spans keyed by "Category/Name" or "layer/stage".  Counters
are filled by the render loop under ``render(collect_stats=True)`` (``cli.py
--stats``): device counts (traced rays, wavefront iterations) are read
once per wave from the stats dicts the integrators return; the registry
never holds a tensor.

Spans are always recorded.  A span is a name, a start and an end in Unix
nanoseconds (``time.time_ns``, the clock of ``torch.profiler``'s events,
so a span can be laid over a device trace), the enclosing span of the
same thread and that thread.  One costs two clock reads and an append:
no device work, no synchronize.  The first ``SPAN_CAP`` records after a
``clear()`` are kept (``spans()``); later ones are only counted, in
``Trace/Spans dropped``.  Per-name aggregates (calls, total and self
seconds, self being the duration less that of the span's children) count
every span.  A timer is a span whose total is reported among the
counters, as the reference's timers are.

    from shimmer_tpu_torch.utils import stats
    stats.counter("Integrator/Rays traced").add(n)
    with stats.timer("Render/Wave time"):
        ...
    with stats.span("wavefront/trace"):
        ...

    @stats.span("sampler/draw")
    def get_1d(...): ...

    print(stats.report())
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
from array import array
from collections import defaultdict
from typing import NamedTuple

SPAN_CAP = 1 << 18
DROPPED = "Trace/Spans dropped"


class _Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def add(self, n):
        self.value += float(n)


class SpanRecord(NamedTuple):
    index: int      # order of opening since the last clear()
    name: str
    start_ns: int   # Unix time, as torch.profiler's events
    end_ns: int
    parent: int     # index of the enclosing span of the same thread, -1 for none
    thread: int     # the opening thread's threading.get_ident()


class _Span:
    """The spans of one name: a context manager and a decorator that
    record one span a use, and the name's aggregate over them."""

    __slots__ = ("name", "_id", "calls", "total_ns", "self_ns")

    def __init__(self, name: str, ident: int):
        self.name, self._id = name, ident
        self.calls = 0
        self.total_ns = 0
        self.self_ns = 0

    @property
    def seconds(self) -> float:
        return self.total_ns * 1e-9

    @seconds.setter
    def seconds(self, value: float):
        self.total_ns = round(value * 1e9)

    @property
    def self_seconds(self) -> float:
        return self.self_ns * 1e-9

    def __enter__(self):
        stack = _tls.stack
        parent = stack[-1][0] if stack and stack[-1][5] == _gen else -1
        stack.append([next(_seq), self, _now(), 0, parent, _gen])
        return self

    def __exit__(self, *exc):
        end = _now()
        t = _tls
        stack = t.stack
        idx, _, start, children, parent, gen = stack.pop()
        dur = end - start
        if stack:
            stack[-1][3] += dur
        with _lock:
            if gen != _gen:
                return False
            self.calls += 1
            self.total_ns += dur
            self.self_ns += dur - children
            if idx < SPAN_CAP:
                _index.append(idx)
                _starts.append(start)
                _ends.append(end)
                _ids.append(self._id)
                _parents.append(parent)
                _tids.append(t.tid)
            else:
                _counters[DROPPED].value += 1.0
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with self:
                return fn(*args, **kwargs)

        return spanned


class _Thread(threading.local):
    """A thread's open spans, innermost last: [index, span, start, children's
    ns, parent index, generation]."""

    def __init__(self):
        self.stack = []
        self.tid = threading.get_ident()


_counters: dict[str, _Counter] = defaultdict(_Counter)
_spans: dict[str, _Span] = {}
_timer_names: set[str] = set()
_lock = threading.Lock()
_tls = _Thread()
_now = time.time_ns
# Indices in opening order since the last clear(), which starts a new
# generation; the records, one column each, in closing order.
_seq = itertools.count()
_gen = 0
_index, _starts, _ends = array("q"), array("q"), array("q")
_ids, _parents, _tids = array("i"), array("i"), array("q")


def counter(name: str) -> _Counter:
    return _counters[name]


def span(name: str) -> _Span:
    """The spans named ``name``: ``with span(name):`` or ``@span(name)``."""
    sp = _spans.get(name)
    if sp is None:
        with _lock:
            sp = _spans.setdefault(name, _Span(name, len(_spans)))
    return sp


def timer(name: str) -> _Span:
    """A span reported among the counters: its ``seconds`` and ``calls``."""
    _timer_names.add(name)
    return span(name)


def clear():
    """Drops the counters, the timers, the span records and every span's
    aggregate.  Spans open now are neither recorded nor counted when they
    close."""
    global _gen, _seq
    with _lock:
        _counters.clear()
        _timer_names.clear()
        for sp in _spans.values():
            sp.calls = sp.total_ns = sp.self_ns = 0
        for col in (_index, _starts, _ends, _ids, _parents, _tids):
            del col[:]
        _seq = itertools.count()
        _gen += 1


def spans() -> list[SpanRecord]:
    """The closed spans recorded since the last ``clear()``, in the order
    they were opened."""
    with _lock:
        cols = [c.tolist() for c in (_index, _starts, _ends, _ids, _parents, _tids)]
        names = {sp._id: sp.name for sp in _spans.values()}
    return sorted(SpanRecord(i, names[n], s, e, p, t) for i, s, e, n, p, t in zip(*cols))


def as_dict() -> dict:
    out = {k: c.value for k, c in _counters.items()}
    out.update({k: _spans[k].seconds for k in _timer_names})
    return out


def _fmt_count(v: float) -> str:
    if v >= 1e9:
        return f"{v / 1e9:.2f}G"
    if v >= 1e6:
        return f"{v / 1e6:.2f}M"
    if v >= 1e3:
        return f"{v / 1e3:.2f}k"
    return f"{v:.0f}" if v == int(v) else f"{v:.2f}"


def report() -> str:
    """pbrt-style report grouped by category, then the spans (other than
    timers) by name, when there are any."""
    groups: dict[str, list[str]] = defaultdict(list)
    for name, c in sorted(_counters.items()):
        cat, _, leaf = name.rpartition("/")
        groups[cat or "Misc"].append(f"    {leaf:<42s} {_fmt_count(c.value)}")
    for name in sorted(_timer_names):
        t = _spans[name]
        cat, _, leaf = name.rpartition("/")
        groups[cat or "Misc"].append(f"    {leaf:<42s} {t.seconds:.2f}s ({t.calls} calls)")
    lines = ["Statistics:"]
    for cat in sorted(groups):
        lines.append(f"  {cat}")
        lines.extend(groups[cat])
    shown = sorted(n for n, sp in _spans.items() if sp.calls and n not in _timer_names)
    if shown:
        lines.append(f"  {'Spans':<44s} {'calls':>10s} {'total':>11s} {'self':>11s}")
        for name in shown:
            sp = _spans[name]
            lines.append(f"    {name:<42s} {sp.calls:>10d} {sp.seconds:>10.3f}s "
                         f"{sp.self_seconds:>10.3f}s")
    return "\n".join(lines)
