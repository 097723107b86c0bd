"""The CUDA traversal kernel's own per-ray body (csrc/traverse_body.cuh),
compiled for the host with g++ (csrc/traverse_host.cpp), against the
port's plain torch traversal on the cases of test_torch_traverse.py.

The body walks the BVH in the reference kernel's order (lowest pending
slot first) and the plain version nearest child first, so a different
winner is allowed only at an exact tie in t; t itself must be bit-equal
(both are unfused IEEE float32 in the same operand order).  Any-hit lanes
compare only their occlusion bit.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from shimmer_tpu_torch.ops.traverse import CSRC, KERNEL_MAX_STACK
from torch_parity import (
    CASES,
    port_traverse,
    traverse_case_rays,
    traverse_scene,
    triangle_t,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def host_body(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host build of the kernel body needs it")
    out = Path(tmp_path_factory.mktemp("traverse_host")) / "libtraverse_host.so"
    subprocess.run(
        [gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
         "-I", str(CSRC), str(CSRC / "traverse_host.cpp"), "-o", str(out)],
        check=True, capture_output=True, timeout=300,
    )
    lib = ctypes.CDLL(str(out))
    p = ctypes.c_void_p
    lib.shimmer_traverse_host.argtypes = [p, p, ctypes.c_int, p, p, p, p, p, p, p, ctypes.c_int]
    lib.shimmer_traverse_host.restype = None
    lib.shimmer_traverse_max_stack.restype = ctypes.c_int
    assert lib.shimmer_traverse_max_stack() == KERNEL_MAX_STACK
    return lib


@pytest.fixture(scope="module")
def scenes():
    return {name: traverse_scene(name) for name in ("soup", "bench")}


def _host(lib, tt, o, d, t_max, want):
    rows = np.ascontiguousarray(tt.rows8.numpy())
    meta = np.ascontiguousarray(tt.meta.numpy())
    o, d = np.ascontiguousarray(o, np.float32), np.ascontiguousarray(d, np.float32)
    t_max = np.ascontiguousarray(t_max, np.float32)
    flags = np.ascontiguousarray(want, np.uint8)
    n = len(o)
    t = np.empty(n, np.float32)
    tri = np.empty(n, np.int32)
    steps = np.empty(n, np.int32)
    lib.shimmer_traverse_host(
        rows.ctypes.data, meta.ctypes.data, rows.shape[0], o.ctypes.data,
        d.ctypes.data, t_max.ctypes.data, flags.ctypes.data, t.ctypes.data,
        tri.ctypes.data, steps.ctypes.data, n,
    )
    return t, tri, steps


@pytest.mark.parametrize("case", CASES + ["grazing"])
@pytest.mark.parametrize("scene", ["soup", "bench"])
def test_body_matches_plain(host_body, scenes, scene, case):
    sc = scenes[scene]
    o, d, t_max, want = traverse_case_rays(sc, case)
    t_h, tri_h, steps = _host(host_body, sc["tt"], o, d, t_max, want)
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
