"""Render-statistics registry (port of ``shimmer_tpu/utils/stats.py``, an
analogue of pbrt's stats system).

Host-side counters and timers keyed by "Category/Name", filled by the
render loop (``render.py`` with ``collect_stats=True``, ``cli.py
--stats``).  Device counts (traced rays, wavefront iterations) are read
once per wave from the stats dicts the integrators return and recorded
here; the registry never holds a tensor.

    from shimmer_tpu_torch.utils import stats
    stats.counter("Integrator/Rays traced").add(n)
    with stats.timer("Render/Wave time"):
        ...
    print(stats.report())
"""

from __future__ import annotations

import time
from collections import defaultdict


class _Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def add(self, n):
        self.value += float(n)


class _Timer:
    __slots__ = ("seconds", "calls", "_t0")

    def __init__(self):
        self.seconds = 0.0
        self.calls = 0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds += time.perf_counter() - self._t0
        self.calls += 1
        return False


_counters: dict[str, _Counter] = defaultdict(_Counter)
_timers: dict[str, _Timer] = defaultdict(_Timer)


def counter(name: str) -> _Counter:
    return _counters[name]


def timer(name: str) -> _Timer:
    return _timers[name]


def clear():
    _counters.clear()
    _timers.clear()


def as_dict() -> dict:
    out = {k: c.value for k, c in _counters.items()}
    out.update({k: t.seconds for k, t in _timers.items()})
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
    """pbrt-style report grouped by category."""
    groups: dict[str, list[str]] = defaultdict(list)
    for name, c in sorted(_counters.items()):
        cat, _, leaf = name.rpartition("/")
        groups[cat or "Misc"].append(f"    {leaf:<42s} {_fmt_count(c.value)}")
    for name, t in sorted(_timers.items()):
        cat, _, leaf = name.rpartition("/")
        groups[cat or "Misc"].append(f"    {leaf:<42s} {t.seconds:.2f}s ({t.calls} calls)")
    lines = ["Statistics:"]
    for cat in sorted(groups):
        lines.append(f"  {cat}")
        lines.extend(groups[cat])
    return "\n".join(lines)
