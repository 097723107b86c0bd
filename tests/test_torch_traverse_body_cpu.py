"""The CUDA traversal kernel's own per-ray body (csrc/traverse_body.cuh),
compiled for the host with g++ (csrc/traverse_host.cpp), against the
port's plain torch traversal on the cases of test_torch_traverse.py.

The body walks the BVH in the reference kernel's order (lowest pending
slot first) and the plain version nearest child first, so a different
winner is allowed only at an exact tie in t; t itself must be bit-equal
(both are unfused IEEE float32 in the same operand order).  Any-hit lanes
compare only their occlusion bit.
"""

import numpy as np
import pytest
import torch

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
