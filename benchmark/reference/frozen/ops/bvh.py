"""Binary BVH hierarchy over per-triangle AABBs (host, numpy only).

The port's own copy of the LBVH builder of ``shimmer_tpu/ops/bvh.py``:
Karras-2012 radix splits over 60-bit Morton keys, with every internal node
splitting its primitive range at the highest differing Morton bit and
subtrees of at most ``leaf_size`` primitives collapsing into leaves.  The
build (RMQ split search over a sparse table, level-synchronous hierarchy
emission, range-union bounds) is vectorized numpy.  ``ops/bvh8.py`` uses it
as the fallback when the native binned-SAH builder (``native/``) is not
available.  The threaded BVH2 layout of the reference (``build_bvh``,
``pack_fat_bvh``) serves only its XLA traversal and is not copied.
"""

from __future__ import annotations

import numpy as np


def morton_encode_3d(q: np.ndarray) -> np.ndarray:
    """Interleave 20-bit x/y/z quantized coords into 60-bit Morton codes."""

    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
        v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
        return v

    return (
        (spread(q[:, 2]) << np.uint64(2))
        | (spread(q[:, 1]) << np.uint64(1))
        | spread(q[:, 0])
    )


def _common_prefix_lengths(keys: np.ndarray) -> np.ndarray:
    """cpl[i] = number of leading common bits of keys[i], keys[i+1]
    (with index tie-break for equal keys, Karras §4)."""
    n = len(keys)
    x = keys[:-1] ^ keys[1:]
    cpl = np.full(n - 1, 64, np.int64)
    for b in range(63, -1, -1):
        has = ((x >> np.uint64(b)) & np.uint64(1)) == 1
        first = has & (cpl == 64)
        cpl[first] = 63 - b
    eq = x == 0
    if eq.any():
        idx = np.arange(n - 1, dtype=np.uint64)
        tie = idx ^ (idx + np.uint64(1))
        tcp = np.full(n - 1, 64, np.int64)
        for b in range(63, -1, -1):
            has = ((tie >> np.uint64(b)) & np.uint64(1)) == 1
            first = has & (tcp == 64)
            tcp[first] = 63 - b
        cpl = np.where(eq, 64 + tcp, cpl)
    return cpl


class _ArgminSparseTable:
    """Vectorized range-argmin over a fixed array (ties → leftmost)."""

    def __init__(self, values: np.ndarray):
        self.values = values
        n = len(values)
        self.tables = [np.arange(n, dtype=np.int64)]
        j = 1
        while (1 << j) <= n:
            h = 1 << (j - 1)
            prev = self.tables[-1]
            a = prev[: n - (1 << j) + 1]
            b = prev[h : h + n - (1 << j) + 1]
            take_a = values[a] <= values[b]
            self.tables.append(np.where(take_a, a, b))
            j += 1

    def query(self, l: np.ndarray, r: np.ndarray) -> np.ndarray:
        """argmin over [l, r] inclusive, vectorized; requires l <= r."""
        length = r - l + 1
        jl = np.floor(np.log2(length)).astype(np.int64)
        res = np.empty(len(l), np.int64)
        for jv in np.unique(jl):
            m = jl == jv
            t = self.tables[jv]
            a = t[l[m]]
            b = t[r[m] - (1 << jv) + 1]
            res[m] = np.where(self.values[a] <= self.values[b], a, b)
        return res


class _RangeUnion:
    """Vectorized AABB union over leaf ranges via overlapping power-of-two
    segments (min/max are idempotent, so overlap is harmless)."""

    def __init__(self, lo: np.ndarray, hi: np.ndarray):
        self.lo_t = [lo]
        self.hi_t = [hi]
        n = len(lo)
        j = 1
        while (1 << j) <= n:
            h = 1 << (j - 1)
            pl, ph = self.lo_t[-1], self.hi_t[-1]
            self.lo_t.append(np.minimum(pl[: len(pl) - h], pl[h:]))
            self.hi_t.append(np.maximum(ph[: len(ph) - h], ph[h:]))
            j += 1

    def query(self, l: np.ndarray, r: np.ndarray):
        length = r - l + 1
        jl = np.floor(np.log2(length)).astype(np.int64)
        lo = np.empty((len(l), 3), np.float32)
        hi = np.empty((len(l), 3), np.float32)
        for jv in np.unique(jl):
            m = jl == jv
            a = l[m]
            b = r[m] + 1 - (1 << jv)
            lo[m] = np.minimum(self.lo_t[jv][a], self.lo_t[jv][b])
            hi[m] = np.maximum(self.hi_t[jv][a], self.hi_t[jv][b])
        return lo, hi


def binary_hierarchy(lo: np.ndarray, hi: np.ndarray, leaf_size: int = 4):
    """Build the binary LBVH hierarchy (Karras radix splits) over
    per-primitive AABBs.  Returns a dict of flat arrays describing the
    *tree* (not yet laid out for traversal):

    ``order`` (T,) Morton sort permutation; ``node_l``/``node_r`` (B,)
    primitive ranges (in sorted order, inclusive); ``left``/``right`` (B,)
    child ids (-1 for leaves); ``is_leaf`` (B,); ``lo``/``hi`` (B, 3)
    bounds.  Node 0 is the root.  ``ops/bvh8.py`` collapses it 8-wide.
    """
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    t = lo.shape[0]
    if t == 0:
        raise ValueError("a BVH needs at least one primitive")
    centroids = 0.5 * (lo + hi)
    cmin = centroids.min(axis=0)
    cext = np.maximum(centroids.max(axis=0) - cmin, 1e-12)
    q = np.clip(
        (centroids - cmin) / cext * float((1 << 20) - 1), 0, (1 << 20) - 1
    ).astype(np.uint64)
    order = np.argsort(morton_encode_3d(q), kind="stable").astype(np.int32)
    codes = morton_encode_3d(q)[order]

    tri_lo = lo[order]
    tri_hi = hi[order]

    if t <= leaf_size:
        return {
            "order": order,
            "node_l": np.array([0], np.int64),
            "node_r": np.array([t - 1], np.int64),
            "left": np.array([-1], np.int64),
            "right": np.array([-1], np.int64),
            "is_leaf": np.array([True]),
            "lo": tri_lo.min(0, keepdims=True),
            "hi": tri_hi.max(0, keepdims=True),
        }

    cpl = _common_prefix_lengths(codes)
    rmq = _ArgminSparseTable(cpl)
    union = _RangeUnion(tri_lo, tri_hi)

    # --- pass 1: level-synchronous top-down discovery ---
    # node records: l, r (triangle range), parent id, is_left flag
    nl = [np.array([0], np.int64)]
    nr = [np.array([t - 1], np.int64)]
    nparent = [np.array([-1], np.int64)]
    nleft = [np.array([True])]
    total = 1
    cur_l, cur_r = nl[0], nr[0]
    cur_ids = np.array([0], np.int64)
    while True:
        internal = (cur_r - cur_l + 1) > leaf_size
        if not internal.any():
            break
        l_, r_ = cur_l[internal], cur_r[internal]
        pid = cur_ids[internal]
        split = rmq.query(l_, r_ - 1)  # left = [l, split], right = [split+1, r]
        child_l = np.concatenate([l_, split + 1])
        child_r = np.concatenate([split, r_])
        child_parent = np.concatenate([pid, pid])
        child_left = np.concatenate(
            [np.ones(len(l_), bool), np.zeros(len(l_), bool)]
        )
        ids = total + np.arange(len(child_l), dtype=np.int64)
        nl.append(child_l)
        nr.append(child_r)
        nparent.append(child_parent)
        nleft.append(child_left)
        total += len(child_l)
        cur_l, cur_r, cur_ids = child_l, child_r, ids

    node_l = np.concatenate(nl)
    node_r = np.concatenate(nr)
    parent = np.concatenate(nparent)
    is_left = np.concatenate(nleft)
    n_nodes = total
    is_leaf = (node_r - node_l + 1) <= leaf_size

    # children pointers (scatter from parent arrays)
    left_child = np.full(n_nodes, -1, np.int64)
    right_child = np.full(n_nodes, -1, np.int64)
    ids_all = np.arange(n_nodes, dtype=np.int64)
    has_parent = parent >= 0
    lmask = has_parent & is_left
    rmask = has_parent & ~is_left
    left_child[parent[lmask]] = ids_all[lmask]
    right_child[parent[rmask]] = ids_all[rmask]

    blo, bhi = union.query(node_l, node_r)
    return {
        "order": order,
        "node_l": node_l,
        "node_r": node_r,
        "left": np.where(is_leaf, -1, left_child),
        "right": np.where(is_leaf, -1, right_child),
        "is_leaf": is_leaf,
        "lo": blo,
        "hi": bhi,
    }
