"""Row 15 of the kernel table: the port's step attribution
(shimmer_tpu_torch/ops/packet_step.py::step_attrib) against the
reference's experiments/exp_step_attrib.py::kern, run in interpret mode on
the CPU over the bench scene at 1,280 sphere triangles (the tables of
tests/test_torch_scene.py), G = 2 programs of K = 2 packets, 32 steps, in
all six variants.

The reference reads the TPU-only tiles8; the port reads rows8 and meta,
which are bit-equal to the reference's.  The reference's SMEM stack is
scratch that its code never fully initialises (only slot 0, :139-140);
interpret mode starts it at INT32_MIN and carries it from one program to
the next.  The port takes that as its definition, and the tests run it
twice: as interpret mode defines it, where the pop leaves INT32_MIN in
slot 1 and every step visits row 0, and from a patterned stack (the test
substitutes the value interpret mode fills scratch with), where the chain
walks the table, leaves hit, and program 1 starts from the stack program
0 left.

Tolerances: out rows 2-7 zero, tri and the hit mask equal, t_best within
T_RTOL.  XLA's CPU compiler contracts the leaf's edge functions
(difference_of_products) and the shear into FMAs inside interpret mode
(ROADMAP queue 3, PR 1); the port computes them unfused, as the kernel
does.  The random rays make the edge functions ill-conditioned, so t
moves by up to 645 ulps (5.9e-5 relative) on these inputs.
"""

import functools
import importlib.util

import jax
import jax._src.pallas.primitives as pallas_primitives
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import bench
from shimmer_tpu_torch import bench_scene
from shimmer_tpu_torch.ops import packet_step as ps
from torch_parity import EXPERIMENTS, ensure_reference_sah

torch.set_num_threads(1)

N_TRIS = 1280
G, K, STEPS, P = 2, 2, 32, 128
T_RTOL = 2e-4


@pytest.fixture(scope="module")
def scenes():
    ensure_reference_sah()
    jscene, _, _, _ = bench.build_bench_scene(N_TRIS)
    tscene, _, _ = bench_scene.build_bench_scene(N_TRIS, (16, 8), device="cpu")
    jt, tt = jscene.triangles, tscene.triangles
    assert np.asarray(jt.rows8).tobytes() == tt.rows8.numpy().tobytes()
    assert np.asarray(jt.meta).tobytes() == tt.meta.numpy().tobytes()
    assert jt.stack_depth == tt.stack_depth
    return jt, tt


@pytest.fixture(scope="module")
def reference():
    """exp_step_attrib.py imported by path (it has a main(); its imports
    reach bench.py and shimmer_tpu, which the test side may), at K = 2
    packets and STEPS steps."""
    spec = importlib.util.spec_from_file_location("reference_exp_step_attrib",
                                                  EXPERIMENTS / "exp_step_attrib.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.K, mod.STEPS = K, STEPS
    return mod


def run_reference(mod, jt, rays, variant, stack_size):
    """The pallas_call of exp_step_attrib.py:208-230, in interpret mode."""
    kk = functools.partial(mod.kern, variant=variant, n_rows=int(jt.meta.shape[0]),
                           stack_size=stack_size)
    f = jax.jit(lambda r: pl.pallas_call(
        kk,
        out_shape=jax.ShapeDtypeStruct((G * K, 8, P), jnp.float32),
        grid=(G,),
        in_specs=[
            pl.BlockSpec(memory_space=pl.ANY),
            pl.BlockSpec((K, 16, P), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec(memory_space=pl.ANY),
        ],
        out_specs=pl.BlockSpec((K, 8, P), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
        scratch_shapes=[
            pltpu.SMEM((K, stack_size), jnp.int32),
            pltpu.VMEM(jt.tiles8.shape, jnp.float32),
            pltpu.SMEM(jt.meta.shape, jnp.int32),
            pltpu.SemaphoreType.DMA,
            pltpu.SemaphoreType.DMA,
        ],
        interpret=True,
    )(jt.meta, r, jt.tiles8))
    return np.asarray(f(jnp.asarray(rays)))


def stack_pattern(stack_size):
    """Stack words (child base << 8 | pending bits) over the small table's
    rows, so that the pops walk it."""
    rng = np.random.default_rng(5)
    return (rng.integers(0, 40, (K, stack_size)) * 256
            + rng.integers(0, 256, (K, stack_size))).astype(np.int32)


def assert_attrib_close(got, want):
    assert got.shape == want.shape == (G * K, 8, P)
    np.testing.assert_array_equal(got[:, 2:], 0.0)
    np.testing.assert_array_equal(want[:, 2:], 0.0)
    hit_got, hit_want = got[:, 0] < ps.ATTRIB_T_INIT, want[:, 0] < ps.ATTRIB_T_INIT
    np.testing.assert_array_equal(hit_got, hit_want)
    np.testing.assert_array_equal(got[:, 1], want[:, 1])
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=T_RTOL)


@pytest.mark.parametrize("stack", ["interpret_int32_min", "patterned"])
@pytest.mark.parametrize("variant", ps.ATTRIB_VARIANTS)
def test_step_attrib_matches_interpret_mode(scenes, reference, monkeypatch, variant, stack):
    jt, tt = scenes
    rays = np.random.default_rng(0).standard_normal((G * K, 16, P)).astype(np.float32)
    size = int(jt.stack_depth) + 8
    init = None
    if stack == "patterned":
        pattern = stack_pattern(size)
        fill = pallas_primitives.uninitialized_value

        def patterned(shape, dtype):
            if tuple(shape) == (K, size) and jnp.dtype(dtype) == jnp.int32:
                return jnp.asarray(pattern)
            return fill(shape, dtype)

        monkeypatch.setattr(pallas_primitives, "uninitialized_value", patterned)
        init = torch.from_numpy(pattern)
    want = run_reference(reference, jt, rays, variant, size)
    got, final = ps.step_attrib(tt.rows8, tt.meta, torch.from_numpy(rays), variant, STEPS, K,
                                size, init)
    assert_attrib_close(got.numpy(), want)
    assert final.shape == (K, size) and bool((final[:, 0] == 1).all())
    # Which lanes hit: none while every step visits the root (an internal
    # row, no leaf test) or with the leaf test off; the patterned chain and
    # noscalar's fixed sequence reach leaves.  (noroll tests the first row
    # of r's tile with r's count: on these rays no lane hits there.)
    hits = int((want[:, 1] >= 0).sum())
    if variant == "noscalar" or (stack == "patterned" and variant in ("full", "noint", "nobits")):
        assert hits > 0
    elif variant == "noleaf" or stack != "patterned":
        assert hits == 0


def test_interpret_stack_pins_the_chain_to_the_root(scenes):
    """From interpret mode's INT32_MIN the pop keeps INT32_MIN in slot 1 and
    r = clip((INT32_MIN >> 8) + i, 0, R - 1) = 0 at every step; from other
    contents the chain moves.  The pushes never reach it: they land in
    slot 2, which no pop reads."""
    _, tt = scenes
    size = int(tt.stack_depth) + 8
    meta = tt.meta.tolist()
    n = len(meta)
    start = [[ps.INT32_MIN] * size for _ in range(K)]
    rs, st, visits = ps.attrib_chain(meta, n, G, K, STEPS, size, start, "full")
    assert {r for prog in rs for row in prog for r in row} == {0}
    assert [row[:2] for row in st] == [[1, ps.INT32_MIN]] * K
    assert {v[0] for prog in visits for row in prog for v in row} == {1}
    rs, _, _ = ps.attrib_chain(meta, n, G, K, STEPS, size, stack_pattern(size).tolist(), "full")
    assert len({r for prog in rs for row in prog for r in row}) > STEPS


def test_stack_carries_across_programs(scenes):
    """Program 1 starts from the stack program 0 left: run alone from the
    initial stack, it gives other results."""
    _, tt = scenes
    size = int(tt.stack_depth) + 8
    rays = torch.from_numpy(np.random.default_rng(0).standard_normal((G * K, 16, P))
                            .astype(np.float32))
    init = torch.from_numpy(stack_pattern(size))
    both, final = ps.step_attrib(tt.rows8, tt.meta, rays, "full", STEPS, K, size, init)
    alone, _ = ps.step_attrib(tt.rows8, tt.meta, rays[K:].contiguous(), "full", STEPS, K, size,
                              init)
    assert not torch.equal(both[K:], alone)
    again, _ = ps.step_attrib(tt.rows8, tt.meta, rays[K:].contiguous(), "full", STEPS, K, size,
                              final_after_program_0(tt, rays, size, init))
    assert torch.equal(both[K:], again)
    assert not torch.equal(final, init)


def final_after_program_0(tt, rays, size, init):
    _, st = ps.step_attrib(tt.rows8, tt.meta, rays[:K].contiguous(), "full", STEPS, K, size,
                           init)
    return st
