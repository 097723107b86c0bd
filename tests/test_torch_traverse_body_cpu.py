"""The CUDA traversal kernel's own per-ray body (csrc/traverse_body.cuh),
compiled for the host with g++ (csrc/traverse_host.cpp), against the
port's plain torch traversal on the cases of test_torch_traverse.py.

The v1 body (V1Ray: 16-byte row reads, near-first order with pruned pops)
walks the BVH nearest child first, as the plain version does, but prunes
and ties its own way, so a different winner is allowed only at an exact
tie in t; t itself must be bit-equal (both are unfused IEEE float32 in the
same operand order).  Any-hit lanes compare only their occlusion bit.
Deep, narrow hand-packed BVHs hold the v1 and v2 bodies to their stated
stack bounds (v2's body on the other cases is in
test_torch_traverse_variants.py), and the child-leaf words v2 reads are
the reference's tiles8 column c11.
"""

import types

import numpy as np
import pytest
import torch

from shimmer_tpu.ops.bvh8 import pack_tiles8
from shimmer_tpu_torch.ops import traverse as tv
from torch_parity import (
    CASES,
    build_host_bodies,
    host_traverse,
    port_traverse,
    traverse_case_rays,
    traverse_scene,
    triangle_t,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def host_body(tmp_path_factory):
    lib = build_host_bodies(tmp_path_factory.mktemp("traverse_host"))
    if lib is None:
        pytest.skip("g++ is not installed: the host build of the kernel body needs it")
    return lib


@pytest.fixture(scope="module")
def scenes():
    return {name: traverse_scene(name) for name in ("soup", "bench")}


@pytest.mark.parametrize("case", CASES + ["grazing"])
@pytest.mark.parametrize("scene", ["soup", "bench"])
def test_body_matches_plain(host_body, scenes, scene, case):
    sc = scenes[scene]
    o, d, t_max, want = traverse_case_rays(sc, case)
    t_h, tri_h, steps = host_traverse(host_body, sc["tt"], o, d, t_max, want)
    t_p, tri_p = port_traverse(sc, o, d, t_max, want)
    hit = tri_h >= 0
    np.testing.assert_array_equal(hit, tri_p >= 0)
    closest = hit & ~want
    np.testing.assert_array_equal(t_h[closest], t_p[closest])
    assert np.isinf(t_h[~hit]).all()
    differ = closest & (tri_h != tri_p)
    np.testing.assert_array_equal(triangle_t(sc, o, d, tri_h)[differ], t_p[differ])
    # Dead lanes (t_max <= 0) take no step.
    assert (steps[t_max <= 0] == 0).all()
    assert (steps[t_max > 0] >= 1).all()


# --- a deep, narrow BVH: the stack bound ---

LEAVES_PER_LEVEL = 7


def chain_bvh8(levels, side=False):
    """A hand-packed BVH8 (ops/bvh8.py layout) of `levels` internal rows in
    a chain: internal row 8i holds seven one-triangle leaves (slots 0-6)
    and the next internal row (slot 7); the last one holds eight leaves.
    Each leaf's triangle lies in a plane x = const, x falling with depth,
    and the spine box spans every deeper triangle, so a ray along +x
    through y = 0, z = -0.2 hits every box of every level and reaches the
    spine first.  With ``side``, slot 6 of every spine row but the last is
    instead an internal side row of eight one-triangle leaves just below
    slot 5's plane (its children in a block of rows after the spine), so
    the +x ray enters every level's spine before its side row.  Returns
    (rows8, meta, stack_depth) with the build's own rule stack_depth =
    deepest internal level + 2 (side rows lie no deeper than the last
    spine row)."""
    n_rows = 8 * levels + 1 + (8 * (levels - 1) if side else 0)
    rows = np.zeros((n_rows, 128), np.float32)
    meta = np.zeros(n_rows, np.int32)
    tri_id = 0

    def leaf_x(level, j):
        return 2.0 * (levels - level) - 0.25 * j

    def leaf(child, x):
        nonlocal tri_id
        # One triangle in slot 0 of the leaf row: p0, p1, p2 SoA.
        for k, v in enumerate(((x, -1.0, -1.0), (x, 1.0, -1.0), (x, 0.0, 1.0))):
            for c in range(3):
                rows[child, 8 * (3 * k + c)] = v[c]
        rows[child, 72] = tri_id
        rows[child, 80] = 1.0
        meta[child] = 1
        tri_id += 1
        return (x, -1.0, -1.0, x, 1.0, 1.0)

    def internal(r, base, boxes):
        rows[r, 48] = base
        meta[r] = base << 4
        for slot, box in enumerate(boxes):
            rows[r, 88 + slot] = 1.0
            for g in range(6):
                rows[r, 8 * g + slot] = box[g]

    x_min = leaf_x(levels - 1, 7)
    for level in range(levels):
        r, base = 8 * level, 8 * level + 1
        last = level == levels - 1
        boxes = []
        for slot in range(8):
            child = base + slot
            if slot == 7 and not last:
                boxes.append((x_min, -1.0, -1.0, leaf_x(level + 1, 0), 1.0, 1.0))
            elif slot == 6 and side and not last:
                side_base = 8 * levels + 1 + 8 * level
                xs = [leaf_x(level, 5) - 0.1 - 0.02 * k for k in range(8)]
                internal(child, side_base, [leaf(side_base + k, x) for k, x in enumerate(xs)])
                boxes.append((min(xs), -1.0, -1.0, max(xs), 1.0, 1.0))
            else:
                boxes.append(leaf(child, leaf_x(level, slot)))
        internal(r, base, boxes)
    return torch.from_numpy(rows), torch.from_numpy(meta), levels + 1


def chain_rays():
    """Along +x (the spine is nearest at every level), along -x (the
    shallowest leaves are nearest), and a few skewed rays; the last two
    are any-hit."""
    o = np.array([[-1.0, 0.0, -0.2], [200.0, 0.0, -0.2], [-1.0, 0.3, 0.1],
                  [200.0, -0.2, 0.0], [-1.0, 0.0, -0.2], [200.0, 0.1, 0.0]], np.float32)
    d = np.array([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0], [1.0, 0.001, -0.002],
                  [-1.0, 0.002, 0.001], [1.0, 0.0, 0.0], [-1.0, 0.0, 0.0]], np.float32)
    want = np.array([False, False, False, False, True, True])
    return o, d, np.full(len(o), np.inf, np.float32), want


@pytest.mark.parametrize(
    "kernel, winner, side",
    [("v1", "slot", False), ("v1", "min", False), ("v2", "slot", False), ("v2", "slot", True)],
    ids=["slot", "min", "v2", "v2_side"],
)
def test_deep_narrow_bvh_stays_within_the_stack_bound(host_body, kernel, winner, side):
    """The deepest table the kernels take (stack_depth + 8 = their 64
    entries) against the stated bounds: the internal stack never holds
    more than stack_depth - 1 entries (the proofs in traverse_body.cuh and
    traverse_v2_body.cuh) and v2's leaf backlog never more than
    LEAF_STACK - 2; the +x ray drives each as deep as the chain allows, and
    every ray agrees with the plain version."""
    levels = tv.KERNEL_MAX_STACK - 8 - 1
    rows8, meta, stack_depth = chain_bvh8(levels, side)
    assert stack_depth + 8 == tv.KERNEL_MAX_STACK
    config = tv.TraverseConfig(kernel, "watertight", winner)
    tt = types.SimpleNamespace(rows8=rows8, meta=meta, traverse=config)
    o, d, t_max, want = chain_rays()
    peak = np.zeros(len(o), np.int32)
    leaf_peak = np.zeros(len(o), np.int32)
    t_h, tri_h, steps = host_traverse(host_body, tt, o, d, t_max, want, stack_peak=peak,
                                      leaf_peak=leaf_peak)
    t_p, tri_p = tv.traverse_raw_plain(rows8, stack_depth, torch.from_numpy(o),
                                       torch.from_numpy(d), torch.from_numpy(t_max),
                                       torch.from_numpy(want), winner=winner)
    t_p, tri_p = t_p.numpy(), tri_p.numpy()
    assert (tri_h >= 0).all() and (tri_p >= 0).all()
    closest = ~want
    np.testing.assert_array_equal(t_h[closest], t_p[closest])
    np.testing.assert_array_equal(tri_h[closest], tri_p[closest])
    assert (peak <= stack_depth - 1).all()
    if kernel == "v1":
        # The +x ray's nearest triangle lies at the bottom of the chain.
        assert tri_h[0] == LEAVES_PER_LEVEL * (levels - 1) + 7
        assert peak[0] == stack_depth - 1
        # Reaching the bottom tightens t_best below every pushed entry: they
        # are dropped without a visit.
        assert steps[0] == levels + 1
        assert (leaf_peak == 0).all()
        return
    # Each spine visit adds a leaf entry of seven (six) bits and a leaf
    # visit takes one bit, so the backlog grows until backpressure holds it.
    assert (leaf_peak <= tv.LEAF_STACK - 2).all()
    assert leaf_peak[0] == tv.LEAF_STACK - 2
    # Without side rows each spine entry is taken whole; with them every
    # level leaves its side child on the stack under the next spine entry.
    assert peak[0] == (stack_depth - 2 if side else 1)


@pytest.mark.parametrize("table", ["bench", "chain", "chain_side"])
def test_child_leaf_mask_is_the_reference_c11(scenes, table):
    """The child-leaf words the v2 kernel reads equal column c11 of the
    reference's tiles8 (shimmer_tpu/ops/bvh8.py::pack_tiles8): for node r,
    lane 16 * (r & 7) + 11 of tile r >> 3, on every sublane."""
    if table == "bench":
        rows8, meta = scenes["bench"]["tt"].rows8, scenes["bench"]["tt"].meta
    else:
        rows8, meta, _ = chain_bvh8(tv.KERNEL_MAX_STACK - 9, table == "chain_side")
    n_rows = meta.shape[0]
    tiles = pack_tiles8(rows8.numpy(), meta.numpy())
    r = np.arange(n_rows)
    c11 = tiles[r >> 3, :, 16 * (r & 7) + 11]  # (R, 8 sublanes)
    assert (c11 == c11[:, :1]).all()
    got = tv.child_leaf_mask(meta)
    assert got.dtype == torch.int32 and got.shape == (n_rows,)
    np.testing.assert_array_equal(got.numpy(), c11[:, 0].astype(np.int32))
    internal = (meta.numpy() & 15) == 0
    assert (got.numpy()[internal] > 0).any() and (got.numpy()[~internal] == 0).all()
