"""The port's traversal (ops/traverse.py: sort glue + plain torch version,
the CPU side of the CUDA kernel) against the reference.

Two scenes: the 200-triangle random soup of tests/test_pallas_traverse.py
and the bench geometry (bench.py's displaced sphere at 1,280 triangles
plus the floor and light quads).  References:

* the Pallas kernel in interpret mode (``traverse_packets_raw(...,
  interpret=True)``, sort on, as the production path runs it);
* the XLA bitstack traversal ``_traverse`` run op by op (jax.disable_jit);
* brute force over every triangle with the reference's watertight test,
  evaluated op by op.

Rays: random rays (mostly misses; camera primaries on the bench scene)
and rays aimed at triangle interiors from one to three triangle diameters
away, within 45 degrees of the normal.  A grazing set (84 to 89 degrees
off the normal) goes only to the op-by-op references.

Criteria: equal hit masks; for closest-hit lanes ``tri`` equal except at
exact t ties (the TPU kernel tests leaves for the union of a packet, a
per-ray traversal does not) and ``t`` bit-equal to the op-by-op
references.  Against the interpret-mode Pallas kernel ``t`` may differ by
at most 8 float32 ulps (largest seen: 4) within rtol 1e-6: XLA's CPU
compiler contracts the kernel's ``a*b - c*d`` edge functions into FMAs,
which eager torch and the nvcc -fmad=false kernel never do.  Where the
watertight test is ill-conditioned (grazing hits; origins much closer to
a triangle than its size) that contraction moves t by up to a few 1e-6,
so those rays are held bit-exact to the op-by-op references only.
Any-hit lanes compare only their occlusion bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shimmer_tpu.ops.pallas.traverse import traverse_packets_raw
from shimmer_tpu.shapes.triangle import _traverse, intersect_triangle as jax_intersect
from shimmer_tpu_torch.ops.traverse import traverse_raw, traverse_raw_plain
from torch_parity import (
    CASES,
    port_traverse,
    traverse_case_rays,
    traverse_scene,
    triangle_t,
    ulp_gap,
)

torch.set_num_threads(1)

MAX_ULP_VS_PALLAS = 8


@pytest.fixture(scope="module")
def scenes():
    return {name: traverse_scene(name) for name in ("soup", "bench")}


def _pallas(sc, o, d, t_max, want):
    t, tri = traverse_packets_raw(
        sc["jt"], jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
        any_hit=jnp.asarray(want), interpret=True, sort_rays=True, compact_dead=False,
    )
    return np.asarray(t), np.asarray(tri)


def _xla_op_by_op(sc, o, d, t_max, want):
    with jax.disable_jit():
        t, tri = _traverse(
            sc["jt"], jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
            any_hit=jnp.asarray(want), raw=True,
        )
    return np.asarray(t), np.asarray(tri)


def _brute(sc, o, d, t_max, want):
    """Closest hit over every triangle, op by op; tri in BVH order."""
    jt = sc["jt"]
    idx = np.asarray(jt.indices)
    p = np.asarray(jt.p)
    hit, t, *_ = jax_intersect(
        jnp.asarray(o)[:, None, :], jnp.asarray(d)[:, None, :],
        jnp.asarray(t_max)[:, None], jnp.asarray(p[idx[:, 0]])[None],
        jnp.asarray(p[idx[:, 1]])[None], jnp.asarray(p[idx[:, 2]])[None],
    )
    t = np.asarray(jnp.where(hit, t, jnp.inf))
    live = (t_max > 0)[:, None]
    t = np.where(live, t, np.inf)
    tri = np.where(np.isfinite(t.min(1)), t.argmin(1), -1)
    return t.min(1).astype(np.float32), tri.astype(np.int32)


def _check(sc, case, ref, t_ref, tri_ref, exact):
    o, d, t_max, want = traverse_case_rays(sc, case)
    t, tri = port_traverse(sc, o, d, t_max, want)
    hit, hit_ref = tri >= 0, tri_ref >= 0
    np.testing.assert_array_equal(hit, hit_ref, err_msg=f"{ref}: hit masks differ")
    closest = hit & ~want
    assert np.isinf(t[~hit]).all()
    if exact:
        np.testing.assert_array_equal(t[closest], t_ref[closest])
    else:
        assert ulp_gap(t[closest], t_ref[closest]) <= MAX_ULP_VS_PALLAS
        np.testing.assert_allclose(t[closest], t_ref[closest], rtol=1e-6)
    differ = closest & (tri != tri_ref)
    # A different winner is allowed only at an exact tie in t.
    np.testing.assert_array_equal(triangle_t(sc, o, d, tri_ref)[differ], t[differ])
    if case == "t_max_clip":
        assert not hit.any()
    return int(closest.sum())


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("scene", ["soup", "bench"])
def test_matches_pallas_interpret(scenes, scene, case):
    sc = scenes[scene]
    t_ref, tri_ref = _pallas(sc, *traverse_case_rays(sc, case))
    _check(sc, case, "pallas", t_ref, tri_ref, exact=False)


@pytest.mark.parametrize("case", ["closest", "mixed", "t_max_clip", "grazing"])
@pytest.mark.parametrize("scene", ["soup", "bench"])
def test_matches_xla_traversal(scenes, scene, case):
    sc = scenes[scene]
    t_ref, tri_ref = _xla_op_by_op(sc, *traverse_case_rays(sc, case))
    _check(sc, case, "xla", t_ref, tri_ref, exact=True)


@pytest.mark.parametrize("case", CASES + ["grazing"])
@pytest.mark.parametrize("scene", ["soup", "bench"])
def test_matches_brute_force(scenes, scene, case):
    sc = scenes[scene]
    t_ref, tri_ref = _brute(sc, *traverse_case_rays(sc, case))
    n_hits = _check(sc, case, "brute", t_ref, tri_ref, exact=True)
    if case in ("closest", "ragged_333", "grazing"):
        assert n_hits >= 40  # most aimed rays hit


@pytest.mark.parametrize("scene", ["soup", "bench"])
def test_sorted_equals_unsorted(scenes, scene):
    sc = scenes[scene]
    rays = traverse_case_rays(sc, "mixed")
    t_s, tri_s = port_traverse(sc, *rays, sort_rays=True)
    t_u, tri_u = port_traverse(sc, *rays, sort_rays=False)
    np.testing.assert_array_equal(t_s, t_u)
    np.testing.assert_array_equal(tri_s, tri_u)


def test_plain_counts_its_calls(scenes):
    sc = scenes["soup"]
    o, d, t_max, want = traverse_case_rays(sc, "closest")
    before = traverse_raw_plain.calls
    port_traverse(sc, o, d, t_max, want)
    assert traverse_raw_plain.calls == before + 1
    assert sum(traverse_raw.launches.values()) == 0  # no CUDA tensor was traced


def test_kernel_wrapper_rejects_bad_input(scenes):
    from shimmer_tpu_torch.ops import traverse as tv

    tt = scenes["soup"]["tt"]
    o = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="stack"):
        tv._launch_kernel(tt.rows8, tt.meta, 60, o, o, torch.ones(4),
                          torch.zeros(4, dtype=torch.bool), False)
    with pytest.raises(TypeError, match="dtype"):
        tv._launch_kernel(tt.rows8, tt.meta, tt.stack_depth, o.double(), o,
                          torch.ones(4), torch.zeros(4, dtype=torch.bool), False)
    with pytest.raises(TypeError, match="float32"):
        traverse_raw(tt, o.double(), o, np.inf)
    with pytest.raises(ValueError, match="no traversal for device"):
        traverse_raw(tt, o.to("meta"), o.to("meta"), np.inf)
