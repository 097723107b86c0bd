"""tests/test_robustness.py's five cases in the port, on the CPU, at that
file's sizes and limits: grazing rays against a sphere at the origin and
at an 8k offset, sliver triangles down to 1e-6 wide, and rays from inside
a closed icosphere at the origin and at a 4k offset.

The two leak cases run three ways: through the port's CPU path
(``triangle_scene_intersect`` over the plain traversal), and through the
g++ host builds of the v1 and v2 kernel bodies (``csrc/traverse_host.cpp``,
the code the card runs), each followed by the port's re-intersection.  A
ray that escapes the closed mesh is a watertightness leak of the kernel
itself."""

import os

os.environ.setdefault("OMP_NUM_THREADS", "1")

import numpy as np
import pytest
import torch

from shimmer_tpu_torch.ops.transform import Transform
from shimmer_tpu_torch.ops.traverse import TraverseConfig
from shimmer_tpu_torch.shapes.sphere import make_sphere_data, sphere_intersect
from shimmer_tpu_torch.shapes.triangle import (
    build_triangle_scene,
    intersect_triangle,
    triangle_interaction_from_raw,
    triangle_scene_intersect,
)
from test_robustness import _icosphere
from torch_parity import build_host_bodies, host_traverse

torch.set_num_threads(1)

BODIES = ["plain", "v1", "v2"]


@pytest.fixture(scope="module")
def host_body(tmp_path_factory):
    lib = build_host_bodies(tmp_path_factory.mktemp("traverse_host"))
    if lib is None:
        pytest.skip("g++ is not installed: the host build of the kernel body needs it")
    return lib


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def test_grazing_rays_consistent():
    r = 1.0
    data = make_sphere_data([{"radius": r, "material_id": 0}], device="cpu")
    n = 4096
    rng = np.random.default_rng(0)
    eps = np.concatenate([-np.logspace(-7, -2, n // 2), np.logspace(-7, -2, n // 2)])
    b = (r * (1.0 + eps)).astype(np.float32)
    phi = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    o = np.stack([b * np.cos(phi), b * np.sin(phi), np.full(n, -10.0, np.float32)], -1)
    d = np.broadcast_to(np.array([0, 0, 1.0], np.float32), (n, 3))
    si = sphere_intersect(data, _t(o), _t(d), torch.full((n,), torch.inf))
    valid = si.valid.numpy()
    b64 = np.linalg.norm(o[:, :2].astype(np.float64), axis=1)
    should = b64 < r
    band = np.abs(b64 - r) < 4.0 * 10.0 * np.finfo(np.float32).eps
    wrong = (valid != should) & ~band
    assert not wrong.any(), f"{wrong.sum()} grazing misclassifications"
    p = si.p.numpy()[valid]
    rr = np.linalg.norm(p.astype(np.float64), axis=1)
    assert np.abs(rr - r).max() < 5e-6


def test_grazing_large_translation():
    c = np.array([8192.0, 4096.0, 8192.0])
    r = 1.0
    data = make_sphere_data([{"radius": r, "material_id": 0,
                              "object_to_render": Transform.translate(c)}], device="cpu")
    n = 2048
    rng = np.random.default_rng(1)
    eps = np.concatenate([-np.logspace(-5, -2, n // 2), np.logspace(-5, -2, n // 2)])
    b = r * (1.0 + eps)
    phi = rng.uniform(0, 2 * np.pi, n)
    o = np.stack([c[0] + b * np.cos(phi), c[1] + b * np.sin(phi), np.full(n, c[2] - 50.0)],
                 -1).astype(np.float32)
    d = np.broadcast_to(np.array([0, 0, 1.0], np.float32), (n, 3))
    si = sphere_intersect(data, _t(o), _t(d), torch.full((n,), torch.inf))
    valid = si.valid.numpy()
    b64 = np.linalg.norm(o.astype(np.float64)[:, :2] - c[None, :2], axis=1)
    should = b64 < r
    band = np.abs(b64 - r) < 5e-3
    wrong = (valid != should) & ~band
    assert not wrong.any(), f"{wrong.sum()} misclassified at 8k offset"
    p = si.p.numpy()[valid]
    rr = np.linalg.norm(p.astype(np.float64) - c, axis=1)
    assert np.abs(rr - r).max() < 5e-3


def test_thin_triangle_hits():
    rng = np.random.default_rng(2)
    n = 2048
    widths = 10.0 ** rng.uniform(-6, -1, n)
    p0 = np.stack([-np.ones(n), np.zeros(n), np.zeros(n)], -1)
    p1 = np.stack([np.ones(n), np.zeros(n), np.zeros(n)], -1)
    p2 = np.stack([np.zeros(n), widths, np.zeros(n)], -1)
    b = rng.uniform(0.2, 0.8, (n, 3))
    b /= b.sum(1, keepdims=True)
    target = b[:, 0:1] * p0 + b[:, 1:2] * p1 + b[:, 2:3] * p2
    o = target + np.array([0, 0, 7.0])
    d = np.array([0, 0, -1.0]) + np.zeros((n, 3))
    h, t, b0, b1, b2 = intersect_triangle(_t(o), _t(d), torch.full((n,), torch.inf),
                                          _t(p0), _t(p1), _t(p2))
    hit = h.numpy()
    assert hit.mean() > 0.999, f"{(~hit).sum()} sliver interior misses"
    bsum = (b0 + b1 + b2).numpy()[hit]
    np.testing.assert_allclose(bsum, 1.0, atol=1e-3)


def _leaks(request, body, center, seed):
    v, f = _icosphere(subdiv=2, center=center)
    cfg = TraverseConfig(body if body != "plain" else "v1", "watertight", "slot")
    tris = build_triangle_scene([{"p": v, "indices": f}], device="cpu", traverse=cfg)
    n = 8192
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.broadcast_to(np.asarray(center, np.float32), (n, 3))
    t_max = np.full(n, np.inf, np.float32)
    if body == "plain":
        si = triangle_scene_intersect(tris, _t(o), _t(d), torch.from_numpy(t_max))
    else:
        lib = request.getfixturevalue("host_body")
        _, tri, _ = host_traverse(lib, tris, o, d, t_max, np.zeros(n, bool))
        assert (tri >= 0).all(), f"{(tri < 0).sum()} rays escaped the {body} body"
        si = triangle_interaction_from_raw(tris, _t(o), _t(d), torch.from_numpy(tri))
    return int((~si.valid).sum())


@pytest.mark.parametrize("body", BODIES)
def test_no_leaks_from_inside(request, body):
    leaked = _leaks(request, body, (0.0, 0.0, 0.0), 3)
    assert leaked == 0, f"{leaked} rays leaked through the mesh"


@pytest.mark.parametrize("body", BODIES)
def test_no_leaks_far_from_origin(request, body):
    leaked = _leaks(request, body, (4096.0, 0.0, 4096.0), 4)
    assert leaked == 0, f"{leaked} rays leaked at 4k offset"
