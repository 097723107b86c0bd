"""Helpers for the parity tests of the PyTorch port (tests/test_torch_*.py).

The same numpy inputs, made from a seed, go through a JAX function of
``shimmer_tpu`` and its counterpart in ``shimmer_tpu_torch``; the outputs
come back as numpy arrays and are compared with a stated tolerance.
"""

from __future__ import annotations

import ctypes
import dataclasses
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

from shimmer_tpu.shapes.triangle import build_triangle_scene as jax_build
from shimmer_tpu_torch.bench_scene import bench_camera_film, bench_meshes
from shimmer_tpu_torch.ops.traverse import CSRC, KERNEL_MAX_STACK, LEAF_STACK, traverse_raw
from shimmer_tpu_torch.shapes.triangle import (
    build_triangle_scene as torch_build,
    intersect_triangle as torch_intersect,
)


def to_jax(x):
    return jnp.asarray(x)


def to_torch(x):
    x = np.asarray(x)
    if x.dtype == np.float64:
        x = x.astype(np.float32)
    return torch.from_numpy(np.array(x))


def as_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def run_both(jax_fn, torch_fn, *inputs):
    """Feed the same numpy inputs to both functions; return both outputs
    as (nested tuples of) numpy arrays."""
    jo = jax_fn(*(to_jax(x) for x in inputs))
    to = torch_fn(*(to_torch(x) for x in inputs))
    return _np_tree(jo), _np_tree(to)


def _np_tree(x):
    if isinstance(x, (tuple, list)):
        return tuple(_np_tree(v) for v in x)
    return as_numpy(x)


def assert_parity(jax_fn, torch_fn, *inputs, rtol=0.0, atol=0.0):
    """Outputs equal bit for bit (rtol = atol = 0) or allclose."""
    jo, to = run_both(jax_fn, torch_fn, *inputs)
    jl = jo if isinstance(jo, tuple) else (jo,)
    tl = to if isinstance(to, tuple) else (to,)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        if rtol == 0.0 and atol == 0.0:
            np.testing.assert_array_equal(b.astype(a.dtype), a)
        else:
            np.testing.assert_allclose(b, a, rtol=rtol, atol=atol)


def ulp_gap(a, b) -> int:
    """Largest distance in float32 ulps between finite arrays a and b."""
    a = np.ascontiguousarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.ascontiguousarray(b, np.float32).view(np.int32).astype(np.int64)
    a = np.where(a < 0, np.int64(-(2**31)) - a, a)
    b = np.where(b < 0, np.int64(-(2**31)) - b, b)
    return int(np.abs(a - b).max(initial=0))


def jax_scene_to_numpy(scene):
    """A reference Scene's leaves as numpy arrays keyed by field path, and
    its static census keyed the same way."""
    arrays, census = {}, {}

    def walk(obj, prefix):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            key = prefix + f.name
            if f.metadata.get("static", False):
                census[key] = v
            elif v is None:
                continue
            elif dataclasses.is_dataclass(v):
                walk(v, key + ".")
            else:
                arrays[key] = np.asarray(v)

    walk(scene, "")
    return arrays, census


def random_mesh(rng, n_tri=200, spread=2.0):
    """The random triangle soup of tests/test_pallas_traverse.py."""
    c = rng.uniform(-spread, spread, (n_tri, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.3, (n_tri, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.3, (n_tri, 3)).astype(np.float32)
    p = np.concatenate([c, c + e1, c + e2], axis=0)
    idx = np.stack(
        [np.arange(n_tri), np.arange(n_tri) + n_tri, np.arange(n_tri) + 2 * n_tri],
        axis=1,
    ).astype(np.int32)
    return {"p": p, "indices": idx}


def random_rays(rng, n=256, spread=2.0):
    """Random origins and unit directions (tests/test_pallas_traverse.py)."""
    o = rng.uniform(-3 * spread, 3 * spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


# --- traversal scenes and ray sets shared by the traversal tests ---

N_RAYS = 256
CASES = ["closest", "any_hit", "mixed", "t_max_clip", "ragged_77", "ragged_333"]


def aimed_triangle_rays(rng, light_rows, n, grazing=False):
    """Rays toward random interior points of random triangles, from one to
    three triangle diameters away.  Ordinary rays arrive within 45 degrees
    of the triangle's normal (either side); grazing rays 84 to 89 degrees
    off it, where the watertight test is ill-conditioned."""
    tri = light_rows[rng.integers(0, len(light_rows), n), :9].reshape(-1, 3, 3)
    bary = rng.dirichlet([1.0, 1.0, 1.0], n)
    target = np.einsum("nk,nkc->nc", bary, tri)
    normal = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    normal *= np.where(rng.random(n) < 0.5, -1.0, 1.0)[:, None]
    tangent = np.cross(normal, rng.normal(size=(n, 3)))
    tangent /= np.linalg.norm(tangent, axis=1, keepdims=True)
    lo, hi = (84.0, 89.0) if grazing else (0.0, 45.0)
    theta = np.deg2rad(rng.uniform(lo, hi, (n, 1)))
    w = np.cos(theta) * normal + np.sin(theta) * tangent
    size = np.linalg.norm(tri - tri[:, :1], axis=-1).max(axis=1, keepdims=True)
    o = (target + w * size * rng.uniform(1.0, 3.0, (n, 1))).astype(np.float32)
    return o, (-w).astype(np.float32), target.astype(np.float32)


def traverse_scene(name):
    """Half the rays mostly miss, half are aimed at triangle interiors."""
    rng = np.random.default_rng(7)
    if name == "soup":
        meshes = [random_mesh(rng)]
    else:
        cam, _ = bench_camera_film((16, 8))
        meshes = bench_meshes(1280, cam.camera_transform.render_from_world())
    jt = jax_build(meshes, traversal="pallas")
    tt = torch_build(meshes, device="cpu")
    light_rows = tt.light_rows.numpy()
    o_b, d_b, targets = aimed_triangle_rays(rng, light_rows, N_RAYS // 2)
    o_g, d_g, _ = aimed_triangle_rays(rng, light_rows, N_RAYS, grazing=True)
    if name == "soup":
        o_a, d_a = random_rays(rng, N_RAYS // 2)
    else:
        # Primary rays through the pixel centres of a 16x8 bench camera.
        ys, xs = np.meshgrid(np.arange(8), np.arange(16), indexing="ij")
        p_film = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32) + 0.5
        ray = cam.generate_ray(torch.from_numpy(p_film), torch.zeros(len(p_film), 2))
        o_a, d_a = ray.o.numpy(), ray.d.numpy()
    o = np.concatenate([o_a, o_b]).astype(np.float32)
    d = np.concatenate([d_a, d_b]).astype(np.float32)
    return {"jt": jt, "tt": tt, "o": o, "d": d, "o_grazing": o_g, "d_grazing": d_g,
            "targets": targets}


def traverse_case_rays(sc, case):
    """(o, d, t_max, want) for a case, as numpy arrays."""
    o, d = sc["o"], sc["d"]
    n = len(o)
    inf = np.full(n, np.inf, np.float32)
    if case == "closest":
        return o, d, inf, np.zeros(n, bool)
    if case == "any_hit":
        return o, d, inf, np.ones(n, bool)
    if case == "grazing":
        return sc["o_grazing"], sc["d_grazing"], inf, np.zeros(n, bool)
    if case == "mixed":
        # The wavefront's merged layout: n extension rays, then n shadow
        # rays (segments toward triangle points, t_max = 1 - 1e-3), with
        # dead lanes at t_max = -inf in both halves.
        rng = np.random.default_rng(11)
        tgt = sc["targets"][rng.integers(0, len(sc["targets"]), n)]
        sh_d = (tgt - o).astype(np.float32)
        t_ext = np.where(rng.random(n) < 0.4, -np.inf, np.inf).astype(np.float32)
        t_sh = np.where(rng.random(n) < 0.4, -np.inf, 1.0 - 1e-3).astype(np.float32)
        return (
            np.concatenate([o, o]), np.concatenate([d, sh_d]),
            np.concatenate([t_ext, t_sh]), np.arange(2 * n) >= n,
        )
    if case == "t_max_clip":
        t_full, _ = traverse_raw(sc["tt"], torch.from_numpy(o), torch.from_numpy(d), np.inf)
        t_full = t_full.numpy()
        t_clip = np.where(np.isfinite(t_full), 0.5 * t_full, 1e-3).astype(np.float32)
        return o, d, t_clip, np.zeros(n, bool)
    if case.startswith("ragged_"):
        k = int(case.split("_")[1])
        reps = -(-k // n)
        oo = np.concatenate([o] * reps)[:k]
        dd = np.concatenate([d] * reps)[:k]
        return oo, dd, np.full(k, np.inf, np.float32), np.zeros(k, bool)
    raise ValueError(case)


def port_traverse(sc, o, d, t_max, want, sort_rays=True):
    t, tri = traverse_raw(
        sc["tt"], torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max),
        any_hit=torch.from_numpy(want), sort_rays=sort_rays,
    )
    return t.numpy(), tri.numpy()


def triangle_t(sc, o, d, tri):
    """t of triangle ``tri`` (BVH order) per ray, from the port's test."""
    attr = sc["tt"].attr_rows[torch.from_numpy(np.maximum(tri, 0)).long()]
    _, t, *_ = torch_intersect(
        torch.from_numpy(o), torch.from_numpy(d), torch.full((len(o),), np.inf),
        attr[:, 19:22], attr[:, 22:25], attr[:, 25:28],
    )
    return t.numpy()


# --- the kernels' per-ray bodies, built for the host with g++ ---


def build_host_bodies(out_dir):
    """Compile csrc/traverse_host.cpp (the v1 and v2 bodies) with g++ and
    no FMA contraction; returns the ctypes library, or None without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    out = Path(out_dir) / "libtraverse_host.so"
    subprocess.run(
        [gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
         "-I", str(CSRC), str(CSRC / "traverse_host.cpp"), "-o", str(out)],
        check=True, capture_output=True, timeout=300,
    )
    lib = ctypes.CDLL(str(out))
    p, ci = ctypes.c_void_p, ctypes.c_int
    lib.shimmer_traverse_host.argtypes = [ci, ci, ci, p, p, ci, p, p, p, p, p, p, p, p, ci]
    lib.shimmer_traverse_host.restype = ci
    lib.shimmer_traverse_max_stack.restype = ci
    lib.shimmer_traverse_leaf_stack.restype = ci
    assert lib.shimmer_traverse_max_stack() == KERNEL_MAX_STACK
    assert lib.shimmer_traverse_leaf_stack() == LEAF_STACK
    return lib


def host_traverse(lib, tt, o, d, t_max, want, config=None, touched=None):
    """Run the host build of the body selected by ``config`` (default: the
    table's own) over the rays; returns (t, tri, steps) as numpy arrays.
    ``touched``, a zeroed (2 * R,) uint8 array, records the rows and meta
    words the body reads."""
    config = tt.traverse if config is None else config
    rows = np.ascontiguousarray(tt.rows8.numpy())
    meta = np.ascontiguousarray(tt.meta.numpy())
    o, d = np.ascontiguousarray(o, np.float32), np.ascontiguousarray(d, np.float32)
    t_max = np.ascontiguousarray(t_max, np.float32)
    flags = np.ascontiguousarray(want, np.uint8)
    n = len(o)
    t = np.empty(n, np.float32)
    tri = np.empty(n, np.int32)
    steps = np.empty(n, np.int32)
    rc = lib.shimmer_traverse_host(
        1 if config.kernel == "v1" else 2, int(config.leaf == "mt"),
        int(config.winner == "min"), rows.ctypes.data, meta.ctypes.data, rows.shape[0],
        o.ctypes.data, d.ctypes.data, t_max.ctypes.data, flags.ctypes.data, t.ctypes.data,
        tri.ctypes.data, steps.ctypes.data,
        None if touched is None else touched.ctypes.data, n,
    )
    assert rc == 0, config
    return t, tri, steps
