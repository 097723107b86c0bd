"""The layered walks replayed from captured CUDA graphs.

A coated material's f, sample and pdf are random walks of a fixed number
of masked steps (``layered.LAYER_MAX_DEPTH``): thousands of small kernels
a call, and on the card the host's launches of them, not their device
work, set the pace.  A walk has no data-dependent shape and no host read,
so where the inputs allow it (:func:`eager_reason`) it is captured once
into a ``torch.cuda.CUDAGraph`` and replayed: its inputs are copied into
the graph's static buffers, one launch runs every kernel, and the caller
gets clones of the static outputs.  The same kernels run on the same
inputs, so the result is the eager walk's, bit for bit.

Elsewhere (the CPU, autograd that needs the walk's gradient, a stream
already capturing, a full cache) the walk runs op by op as before.  The
registry counts each way: ``Material/Walk graph captures``, ``Material/Walk
graph replays`` and ``Material/Walks eager``, the last also by reason.
"""

from __future__ import annotations

import weakref

import torch

from shimmer_tpu_torch.utils import stats

CAPTURES = "Material/Walk graph captures"
REPLAYS = "Material/Walk graph replays"
EAGER = "Material/Walks eager"

# Graphs kept at most; past the bound a walk of a new key runs eagerly.
GRAPH_BOUND = 8


def eager_reason(args, tables) -> str | None:
    """Why the walk over ``args`` reading ``tables`` must run op by op, or
    None where a graph may replay it."""
    if not all(t.is_cuda for t in args):
        return "no CUDA"
    if torch.is_grad_enabled() and any(t.requires_grad for t in (*args, *tables)):
        return "grad"
    if torch.cuda.is_current_stream_capturing():
        return "capturing"
    return None


def _describe(t):
    return (t.shape, t.stride(), t.dtype, t.device)


# One memory pool a device, shared by every walk's graph: the replays run in
# turn on the caller's stream and each output is cloned before the next
# replay, so no two graphs' intermediates are in use at once.
_POOLS: dict = {}


class _Graph:
    """One captured walk: static inputs, the graph, static outputs."""

    def __init__(self, fn, args):
        dev = args[0].device
        pool = _POOLS.get(dev)
        if pool is None:
            pool = _POOLS[dev] = torch.cuda.graph_pool_handle()
        with torch.cuda.device(dev), torch.no_grad():
            self.static = [a.clone() for a in args]
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            # The warm-up does each kernel's first-use work outside the capture.
            with torch.cuda.stream(side):
                fn(*self.static)
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, pool=pool, stream=side,
                                  capture_error_mode="thread_local"):
                self.outs = fn(*self.static)
        self.device = dev

    def __call__(self, args):
        with torch.cuda.device(self.device):
            for s, a in zip(self.static, args):
                s.copy_(a)
            self.graph.replay()
            return tuple(o.clone() for o in self.outs)


class WalkGraphs:
    """Captured walks by key, at most ``bound`` of them.

    ``run(name, fn, args, tables)`` returns ``fn(*args)``, a tuple of
    tensors.  The key is ``name`` (which walk, of which coated kind, with
    the flags that fix its work), each input's shape, strides, dtype and
    device (the lane count among them), and the identity, address and
    layout of each table the walk reads by address.  ``capture(fn, args)``
    gives a callable that replays the walk on new inputs of the same key."""

    def __init__(self, bound: int = GRAPH_BOUND, capture=_Graph):
        self.bound = bound
        self.capture = capture
        self.graphs: dict = {}   # key -> (replay, weak references to the tables)

    def key(self, name, args, tables) -> tuple:
        return (name, tuple(_describe(a) for a in args),
                tuple(None if t is None else (id(t), t.data_ptr(), *_describe(t))
                      for t in tables))

    def _drop_dead(self):
        """Forgets the graphs whose tables are gone (a rebuilt scene)."""
        for k in [k for k, (_, refs) in self.graphs.items() if any(r() is None for r in refs)]:
            del self.graphs[k]

    def run(self, name, fn, args, tables):
        key = self.key(name, args, tables)
        entry = self.graphs.get(key)
        if entry is None:
            if len(self.graphs) >= self.bound:
                self._drop_dead()
            if len(self.graphs) >= self.bound:
                return run_eagerly(fn, args, "cache full")
            entry = self.graphs[key] = (
                self.capture(fn, args), [weakref.ref(t) for t in tables if t is not None])
            stats.counter(CAPTURES).add(1)
        else:
            stats.counter(REPLAYS).add(1)
        return entry[0](args)


def run_eagerly(fn, args, reason: str):
    stats.counter(EAGER).add(1)
    stats.counter(f"{EAGER}: {reason}").add(1)
    return fn(*args)


_CACHE = WalkGraphs()


def run(name, fn, args, tables):
    """``fn(*args)`` (a tuple of tensors), replayed from a graph where
    :func:`eager_reason` allows, else op by op."""
    reason = eager_reason(args, [t for t in tables if t is not None])
    if reason is not None:
        return run_eagerly(fn, args, reason)
    return _CACHE.run(name, fn, args, tables)
