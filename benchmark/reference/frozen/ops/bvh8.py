"""8-wide BVH ("BVH8") build and packed-row layout (host, numpy only).

The port's own copy of ``shimmer_tpu/ops/bvh8.py`` (``pack_bvh8``,
``BVH8Arrays``, ``bvh8_validate``); it builds ``rows8``, ``meta`` and
``perm`` byte-identical to the reference's on the same meshes.  The TPU
sublane repack ``pack_tiles8`` is not copied: the CUDA kernels read
``rows8`` directly.

Layout (one (128,) f32 row per node, two kinds):

* **internal row**: cols 0:48 = the 8 child AABBs laid out SoA-in-row
  ``[lox*8 | loy*8 | loz*8 | hix*8 | hiy*8 | hiz*8]``; col 48 =
  ``child_base``; col 80 = 0; cols 88:96 = per-slot valid flags (1.0 for
  occupied slots; empty slots hold zero boxes and must be masked by the
  flag).  A node's children occupy contiguous rows ``child_base + j`` for
  slot j.
* **leaf row**: cols 0:72 = up to 8 inline triangles SoA-in-row
  ``[p0x*8 | p0y*8 | p0z*8 | p1x*8 | ... | p2z*8]``; cols 72:80 = the 8
  BVH-sorted triangle ids; col 80 = triangle count in 1..8.
  ``pack_leaves_mt`` turns the vertex columns into ``(p0, e1, e2)`` for the
  Moller-Trumbore leaf test.

A parallel ``meta`` int32 array (one per row) packs
``leaf_count | child_base << 4``.  All indices and counts in the rows are
exact small floats (< 2^24).

Build (frozen copy): the LBVH of ``ops/bvh.py`` collapsed 8-wide by
repeatedly expanding the child with the largest triangle range.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from benchmark.reference.frozen.ops.bvh import binary_hierarchy

W8 = 128          # row width (f32)
MAX_LEAF8 = 8     # max triangles per leaf row
_COL_BASE = 48    # internal: child_base
_COL_COUNT = 80   # both: leaf count (0 => internal)
_COL_IDS = 72     # leaf: 8 BVH-sorted triangle ids
_COL_VALID = 88   # internal: 8 slot-valid flags
MAX_GROUP_BASE = (1 << 23) - 1  # group packs base*256+mask into int32


@dataclasses.dataclass
class BVH8Arrays:
    rows: np.ndarray       # (R, 128) f32 packed node/leaf rows
    meta: np.ndarray       # (R,) int32 leaf_count | child_base << 4
    perm: np.ndarray       # (T,) int32 Morton-sorted triangle order
    n_rows: int
    max_depth: int         # max stack depth needed by the traversal


def _collapse8(h, leaf_size=MAX_LEAF8):
    """Collapse the binary hierarchy into 8-wide nodes.

    Returns children: children[i] is the slot list of wide node i, each
    slot ("node", wide_child_id, 0, binary_id) or ("leaf", first_tri,
    count, binary_id).  Wide node 0 is the root.
    """
    node_l, node_r = h["node_l"], h["node_r"]
    left, right = h["left"], h["right"]
    is_leaf = h["is_leaf"]

    def range_count(b):
        return node_r[b] - node_l[b] + 1

    wide_children = []   # list of slot lists
    work = [0]           # binary ids pending wide-node creation
    wide_of_binary = {0: 0}
    wide_children.append(None)

    while work:
        b = work.pop()
        wid = wide_of_binary[b]
        # Expand up to 8 slots: repeatedly split the largest internal.
        slots = [b]
        while len(slots) < 8:
            best, best_n = -1, leaf_size
            for i, s in enumerate(slots):
                if not is_leaf[s]:
                    n = range_count(s)
                    if n > best_n:
                        best, best_n = i, n
            if best < 0:
                break
            s = slots.pop(best)
            slots.insert(best, left[s])
            slots.insert(best + 1, right[s])
        out = []
        for s in slots:
            if is_leaf[s] or range_count(s) <= leaf_size:
                out.append(("leaf", int(node_l[s]), int(range_count(s)), s))
            else:
                cid = len(wide_children)
                wide_children.append(None)
                wide_of_binary[s] = cid
                work.append(s)
                out.append(("node", cid, 0, s))
        wide_children[wid] = out
    return wide_children


def build_bvh8(lo: np.ndarray, hi: np.ndarray, builder: str = "lbvh") -> BVH8Arrays:
    """Build the wide-node structure over per-triangle AABBs: the LBVH of
    ``ops/bvh.py`` collapsed 8-wide.  The frozen copy has no native SAH
    builder, so its hierarchy is built independently of the port's;
    ``builder`` is accepted for the callers' signature and must be
    "auto" or "lbvh".  Triangle payloads are packed later (pack_bvh8
    needs sorted verts).
    """
    if builder not in ("auto", "lbvh"):
        raise ValueError(f"the frozen copy builds only the LBVH, not {builder!r}")
    h = binary_hierarchy(lo, hi, MAX_LEAF8)
    return _layout8(h, _collapse8(h))


def _layout8(h, children):
    blo, bhi = h["lo"], h["hi"]
    n_wide = len(children)

    # Row allocation: root row 0; then BFS, each wide node's child rows
    # (internal-node rows and leaf rows interleaved by slot) contiguous.
    row_of_wide = np.full(n_wide, -1, np.int64)
    row_of_wide[0] = 0
    next_row = 1
    depth_of = np.zeros(n_wide, np.int64)
    order = [0]
    qi = 0
    leaf_rows = []   # (row, first, count)
    child_base = np.zeros(n_wide, np.int64)
    while qi < len(order):
        wid = order[qi]
        qi += 1
        slots = children[wid]
        child_base[wid] = next_row
        for kind, a, cnt, s in slots:
            r = next_row
            next_row += 1
            if kind == "node":
                row_of_wide[a] = r
                depth_of[a] = depth_of[wid] + 1
                order.append(a)
            else:
                leaf_rows.append((r, a, cnt, s))
    n_rows = next_row
    if n_rows > MAX_GROUP_BASE:
        raise ValueError("scene too large for packed int32 groups")

    # All rows finite (zeros): empty internal slots are zero boxes gated
    # by the valid flag (the reference's table is kept free of inf/NaN,
    # and the port's is byte-identical to it).
    rows = np.zeros((n_rows, W8), np.float32)
    meta = np.zeros(n_rows, np.int32)

    # Internal rows: child boxes + base + slot-valid flags.
    for wid in order:
        r = row_of_wide[wid]
        slots = children[wid]
        rows[r, _COL_BASE] = float(child_base[wid])
        rows[r, _COL_COUNT] = 0.0
        meta[r] = int(child_base[wid]) << 4
        for j, (kind, a, cnt, s) in enumerate(slots):
            l3 = blo[s]
            h3 = bhi[s]
            rows[r, 0 + j] = l3[0]
            rows[r, 8 + j] = l3[1]
            rows[r, 16 + j] = l3[2]
            rows[r, 24 + j] = h3[0]
            rows[r, 32 + j] = h3[1]
            rows[r, 40 + j] = h3[2]
            rows[r, _COL_VALID + j] = 1.0
    return BVH8Arrays(
        rows=rows,
        meta=meta,
        perm=h["order"],
        n_rows=n_rows,
        max_depth=int(depth_of.max()) + 2,
    ), leaf_rows


def pack_bvh8(lo, hi, tri_p, builder: str = "auto") -> BVH8Arrays:
    """Full build: hierarchy + collapse + pack triangle leaf rows.

    tri_p: (T, 3, 3) triangle vertices in ORIGINAL order; leaf rows store
    them in BVH (perm) order, ids are perm-order indices.
    """
    arrs, leaf_rows = build_bvh8(lo, hi, builder=builder)
    rows, perm = arrs.rows, arrs.perm
    tri_sorted = np.asarray(tri_p, np.float32)[perm]  # (T, 3, 3)
    t_total = tri_sorted.shape[0]
    if t_total >= (1 << 24):
        raise ValueError("triangle ids must stay exact in f32")
    if leaf_rows:
        lr = np.asarray([(r, f, c) for (r, f, c, _s) in leaf_rows], np.int64)
        r_ids, firsts, counts = lr[:, 0], lr[:, 1], lr[:, 2]
        rows[r_ids, _COL_COUNT] = counts.astype(np.float32)
        arrs.meta[r_ids] = counts.astype(np.int32)
        for k in range(MAX_LEAF8):
            m = counts > k
            if not m.any():
                break
            tri = firsts[m] + k
            v = tri_sorted[tri]  # (M, 3, 3)
            rr = r_ids[m]
            for vi in range(3):
                for ci in range(3):
                    rows[rr, (vi * 3 + ci) * 8 + k] = v[:, vi, ci]
            rows[rr, _COL_IDS + k] = tri.astype(np.float32)
        # Duplicate slot-0 triangles into unused slots so masked lanes
        # compute on real (finite) data; count gates their hits.
        for k in range(1, MAX_LEAF8):
            m = counts <= k
            if not m.any():
                continue
            rr = r_ids[m]
            for c in range(9):
                rows[rr, c * 8 + k] = rows[rr, c * 8]
    return BVH8Arrays(
        rows=rows, meta=arrs.meta, perm=perm, n_rows=arrs.n_rows,
        max_depth=arrs.max_depth,
    )


def pack_leaves_mt(rows: np.ndarray, meta: np.ndarray) -> np.ndarray:
    """Leaf rows with ``(p0, e1 = p1 - p0, e2 = p2 - p0)`` in place of
    ``(p0, p1, p2)``, for the Moller-Trumbore leaf test.  The same f32
    subtraction as the reference's packing of its TPU tiles
    (``shimmer_tpu/ops/bvh8.py::pack_tiles8`` under SHIMMER_LEAF_MT=1),
    applied to the rows: ``e1`` = cols 24:48 - cols 0:24 and ``e2`` = cols
    48:72 - cols 0:24.  Internal rows are unchanged."""
    rows = np.array(rows, np.float32, copy=True)
    leaf = (np.asarray(meta) & 15) > 0
    rows[leaf, 24:48] -= rows[leaf, 0:24]
    rows[leaf, 48:72] -= rows[leaf, 0:24]
    return rows


def bvh8_validate(arrs: BVH8Arrays, lo, hi) -> bool:
    """Host sanity check: every triangle appears exactly once in a leaf
    row, inside that leaf's box as seen from its parent slot."""
    rows = arrs.rows
    t = len(arrs.perm)
    seen = np.zeros(t, np.int32)
    for r in range(arrs.n_rows):
        cnt = int(rows[r, _COL_COUNT])
        if cnt > 0:
            for k in range(cnt):
                tri = int(rows[r, _COL_IDS + k])
                seen[arrs.perm[tri]] += 1
    return bool(np.all(seen == 1))
