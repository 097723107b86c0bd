"""The CUDA traversal kernel's own per-ray body (csrc/traverse_body.cuh),
compiled for the host with g++ (csrc/traverse_host.cpp), against the
port's plain torch traversal on the cases of test_torch_traverse.py.

The v1 body (V1Ray: 16-byte row reads, near-first order with pruned pops)
walks the BVH nearest child first, as the plain version does, but prunes
and ties its own way, so a different winner is allowed only at an exact
tie in t; t itself must be bit-equal (both are unfused IEEE float32 in the
same operand order).  Any-hit lanes compare only their occlusion bit.  A
deep, narrow hand-packed BVH holds the body to its stated stack bound.
"""

import types

import numpy as np
import pytest
import torch

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


def chain_bvh8(levels):
    """A hand-packed BVH8 (ops/bvh8.py layout) of `levels` internal rows in
    a chain: internal row 8i holds seven one-triangle leaves (slots 0-6)
    and the next internal row (slot 7); the last one holds eight leaves.
    Each leaf's triangle lies in a plane x = const, x falling with depth,
    and the spine box spans every deeper triangle, so a ray along +x
    through y = 0, z = -0.2 hits every box of every level and reaches the
    spine first.  Returns (rows8, meta, stack_depth) with the build's own
    rule stack_depth = deepest internal level + 2."""
    n_rows = 8 * levels + 1
    rows = np.zeros((n_rows, 128), np.float32)
    meta = np.zeros(n_rows, np.int32)
    tri_id = 0

    def leaf_x(level, j):
        return 2.0 * (levels - level) - 0.25 * j

    x_min = leaf_x(levels - 1, 7)
    for level in range(levels):
        r, base = 8 * level, 8 * level + 1
        rows[r, 48] = base
        meta[r] = base << 4
        last = level == levels - 1
        for slot in range(8):
            child = base + slot
            rows[r, 88 + slot] = 1.0
            if slot == 7 and not last:
                box = (x_min, -1.0, -1.0, leaf_x(level + 1, 0), 1.0, 1.0)
            else:
                x = leaf_x(level, slot)
                box = (x, -1.0, -1.0, x, 1.0, 1.0)
                # One triangle in slot 0 of the leaf row: p0, p1, p2 SoA.
                for k, v in enumerate(((x, -1.0, -1.0), (x, 1.0, -1.0), (x, 0.0, 1.0))):
                    for c in range(3):
                        rows[child, 8 * (3 * k + c)] = v[c]
                rows[child, 72] = tri_id
                rows[child, 80] = 1.0
                meta[child] = 1
                tri_id += 1
            for g in range(6):
                rows[r, 8 * g + slot] = box[g]
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


@pytest.mark.parametrize("winner", ["slot", "min"])
def test_deep_narrow_bvh_stays_within_the_stack_bound(host_body, winner):
    """The deepest table the kernel takes (stack_depth + 8 = its 64
    entries) against the stated bound: the v1 body never holds more than
    stack_depth - 1 entries (the proof in traverse_body.cuh), reaches
    exactly that on the +x ray, and agrees with the plain version."""
    levels = tv.KERNEL_MAX_STACK - 8 - 1
    rows8, meta, stack_depth = chain_bvh8(levels)
    assert stack_depth + 8 == tv.KERNEL_MAX_STACK
    config = tv.TraverseConfig("v1", "watertight", winner)
    tt = types.SimpleNamespace(rows8=rows8, meta=meta, traverse=config)
    o, d, t_max, want = chain_rays()
    peak = np.zeros(len(o), np.int32)
    t_h, tri_h, steps = host_traverse(host_body, tt, o, d, t_max, want, stack_peak=peak)
    t_p, tri_p = tv.traverse_raw_plain(rows8, stack_depth, torch.from_numpy(o),
                                       torch.from_numpy(d), torch.from_numpy(t_max),
                                       torch.from_numpy(want), winner=winner)
    t_p, tri_p = t_p.numpy(), tri_p.numpy()
    assert (tri_h >= 0).all() and (tri_p >= 0).all()
    closest = ~want
    np.testing.assert_array_equal(t_h[closest], t_p[closest])
    np.testing.assert_array_equal(tri_h[closest], tri_p[closest])
    # The +x ray's nearest triangle lies at the bottom of the chain.
    assert tri_h[0] == LEAVES_PER_LEVEL * (levels - 1) + 7
    assert (peak <= stack_depth - 1).all()
    assert peak[0] == stack_depth - 1
    # Reaching the bottom tightens t_best below every pushed entry: they
    # are dropped without a visit.
    assert steps[0] == levels + 1
