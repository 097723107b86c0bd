"""The port's packet-step kernels (shimmer_tpu_torch/ops/packet_step.py)
against the reference's Pallas packet-step experiments, run in interpret
mode on the CPU: kernel-table rows 10-14 (experiments/exp_scaling.py
make, exp_packet_step.py step_kernel, exp_packet_step2.py make with fetch
A-D, exp_fetch_honest.py make with ``empty`` and A-D,
exp_loop_overhead.py k1-k6) and row 16 (exp_ablate_step.py kern / run,
v0-v4, and its bf16 hi|lo packing), and the port's entry point
(shimmer_tpu_torch/experiments/packet_step.py) as a whole.  Row 15 is in
tests/test_torch_step_attrib.py.

The scripts run their TPU benchmarks when imported, so only their imports
and the named definitions are executed (torch_parity.load_defs), at R =
256 rows, one packet of 128 rays and 16-64 steps, with ``pallas_call`` in
interpret mode; no reference file is edited.  The same numpy arrays,
drawn from a seed, go to both sides.

Tolerances: bit-equal everywhere but two places.  The slab chases sum
whole hit counts and the chains move integers, so any order gives the
same bits; k3, row 16's v0-v3 and the packing compute in the kernel's
order.  k4 (acc + x * i) and row 16's v4 leaf branch (acc + a * b) hold
to rtol CHAIN_RTOL and atol CHAIN_ATOL: XLA's CPU compiler contracts a
product and the sum it feeds into one FMA inside interpret mode (ROADMAP
queue 3, PR 1), the port never does, so each step may round once more
or less (measured: k4 2 ulps after 64 steps; v4 512 ulps, 5.1e-5
relative, on a sum that cancels to a small value after 48 steps).  The
plain versions are bit-equal to the kernels' own bodies
(tests/test_torch_packet_step_body_cpu.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shimmer_tpu_torch.experiments import packet_step as eps
from shimmer_tpu_torch.ops import packet_step as ps
from torch_parity import load_defs

torch.set_num_threads(1)

R, P = 256, 128
# |port - interpret| <= CHAIN_ATOL + CHAIN_RTOL * |value| for sums that
# interpret mode fuses: one rounding of a product of O(1) normals a step,
# a few dozen steps, onto sums of magnitude up to ~100.
CHAIN_RTOL, CHAIN_ATOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def data():
    """The scripts' tables at R = 256, drawn in their order: (128, R)
    transposed nodes (rows 10, 11, 14), (R, 128) rows and their transpose
    (rows 12, 13), nxt, rays."""
    rng = np.random.default_rng(0)
    tab_t = rng.normal(size=(128, R)).astype(np.float32)
    nxt = rng.integers(0, R, size=(R,), dtype=np.int32)
    rays = rng.normal(size=(8, P)).astype(np.float32)
    tab_rows = rng.normal(size=(R, 128)).astype(np.float32)
    return {"tabT": tab_t, "nxt": nxt, "rays": rays, "tab_rows": tab_rows,
            "tab_rows_T": np.ascontiguousarray(tab_rows.T)}


def port_chase(table, nxt, rays, steps, body="slab", transposed=False):
    return ps.packet_slab_chase(torch.from_numpy(table), torch.from_numpy(nxt),
                                torch.from_numpy(rays), steps, body, transposed).numpy()


def assert_bits(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# --- row 10: exp_scaling.py ---


@pytest.mark.parametrize("steps", [16, 64])
def test_scaling_make_10(data, steps):
    ns = load_defs("exp_scaling", ("slab", "fetch_a", "make"), P=P)
    out = np.asarray(ns["make"](steps)(jnp.asarray(data["nxt"]), jnp.asarray(data["rays"]),
                                       jnp.asarray(data["tabT"])))
    got = port_chase(data["tabT"], data["nxt"], data["rays"], steps, transposed=True)
    assert out.any()
    assert_bits(got, out)


# --- row 11: exp_packet_step.py ---


def test_packet_step_11(data):
    """step_kernel with its SMEM stack store (no effect on the output)."""
    ns = load_defs("exp_packet_step", ("step_kernel", "f"), STEPS=48, P=P)
    out = np.asarray(ns["f"](jnp.asarray(data["nxt"]), jnp.asarray(data["rays"]),
                             jnp.asarray(data["tabT"])))
    got = port_chase(data["tabT"], data["nxt"], data["rays"], 48, "slab_stack", True)
    assert_bits(got, out)


# --- row 12: exp_packet_step2.py, fetch A-D ---


@pytest.mark.parametrize("fetch", ["fetch_a", "fetch_b", "fetch_c", "fetch_d"])
def test_fetch_variants_12(data, fetch):
    """A reads the transposed table, B-D the row table; on Hopper all four
    are the one chase over the layout they read (fetch B's identity
    product is exact in interpret mode, as the port's read is)."""
    transposed = fetch == "fetch_a"
    table = data["tab_rows_T"] if transposed else data["tab_rows"]
    ns = load_defs("exp_packet_step2",
                   ("slab", "make", "loop", "fetch_a", "fetch_b", "fetch_c", "fetch_d"),
                   STEPS=32, P=P, nxt=jnp.asarray(data["nxt"]), rays=jnp.asarray(data["rays"]))
    out = np.asarray(ns["make"](ns["loop"](ns[fetch]), jnp.asarray(table))())
    got = port_chase(table, data["nxt"], data["rays"], 32, "slab", transposed)
    assert_bits(got, out)


# --- row 13: exp_fetch_honest.py, empty and A-D at two step counts ---


@pytest.mark.parametrize("fetch", ["empty", "fetch_a", "fetch_b", "fetch_c", "fetch_d"])
def test_fetch_honest_13(data, fetch):
    transposed = fetch == "fetch_a"
    table = data["tab_rows_T"] if transposed else data["tab_rows"]
    ns = load_defs("exp_fetch_honest",
                   ("slab", "make", "fetch_a", "fetch_b", "fetch_c", "fetch_d"), P=P)
    for steps in (16, 40):
        empty = fetch == "empty"
        f = ns["make"](None if empty else ns[fetch], steps, empty)
        out = np.asarray(f(jnp.asarray(data["nxt"]), jnp.asarray(data["rays"]),
                           jnp.asarray(table)))
        got = port_chase(table, data["nxt"], data["rays"], steps,
                         "empty" if empty else "slab", transposed)
        assert_bits(got, out)
        assert empty == (not out.any())


# --- row 14: exp_loop_overhead.py, k1-k6 ---

LOOP_BODIES = {"k1": "int_sum", "k2": "chase", "k3": "acc", "k4": "acc_scaled",
               "k5": "slab_fixed", "k6": "slab"}


@pytest.mark.parametrize("k", sorted(LOOP_BODIES))
def test_loop_overhead_14(data, k):
    steps = 64
    ns = load_defs("exp_loop_overhead", ("slab", "fetch_a", "make", k), STEPS=steps, R=R, P=P)
    out = np.asarray(ns["make"](ns[k])(jnp.asarray(data["nxt"]), jnp.asarray(data["rays"]),
                                       jnp.asarray(data["tabT"])))
    body = LOOP_BODIES[k]
    got = port_chase(data["tabT"], data["nxt"], data["rays"], steps, body, True)
    if k == "k4":
        np.testing.assert_allclose(got, out, rtol=CHAIN_RTOL, atol=CHAIN_ATOL)
    else:
        assert_bits(got, out)


def test_chase_visits_counts_laps():
    """The visit-count form of the plain chase: tail rows once, the cycle's
    rows by whole laps plus the remainder, and the row after the last
    visit; equal to walking the chain step by step."""
    nxt = [3, 0, 1, 5, 2, 4, 6]  # 0 -> 3 -> 5 -> 4 -> 2 -> 1 -> 0
    for r0 in (0, 6):
        for steps in (0, 1, 5, 6, 7, 40):
            order, counts, final = ps.chase_visits(nxt, len(nxt), steps, r0)
            walk, r = [], r0
            for _ in range(steps):
                walk.append(r)
                r = nxt[r]
            assert final == r
            assert dict(zip(order, counts)) == {x: walk.count(x) for x in set(walk)}


# --- row 16: exp_ablate_step.py ---


def reference_packing(tab_f):
    """The script's own numpy packing (exp_ablate_step.py:24-27)."""
    return load_defs("exp_ablate_step", ("hi", "lo", "tab_i"), tab_f=tab_f)["tab_i"]


@pytest.fixture(scope="module")
def ablate_data():
    rng = np.random.default_rng(0)
    tab_f = rng.normal(size=(R, 128)).astype(np.float32)
    nxt = rng.integers(0, R, size=(R,), dtype=np.int32)
    return tab_f, nxt, reference_packing(tab_f)


def test_pack_bf16_hilo_16(ablate_data):
    """pack_bf16_hilo equals the reference's ml_dtypes packing bit for bit,
    on the script's table and on values that round to even, carry into the
    exponent or are subnormal in bf16."""
    tab_f, _, tab_i = ablate_data
    assert_bits(ps.pack_bf16_hilo(torch.from_numpy(tab_f)).numpy(), tab_i)
    edge = np.array([[1.0 + 2.0**-8, 1.0 + 3 * 2.0**-8, 1.0 + 2.0**-7 - 2.0**-23,
                      -(2.0**-130), 3.0e38, -0.0, 65504.0, 1e-45]], np.float32)
    assert_bits(ps.pack_bf16_hilo(torch.from_numpy(edge)).numpy(), reference_packing(edge))
    # hi + lo recovers each float to within bf16's lo precision.
    back = ps.hilo_values(torch.from_numpy(tab_i)).numpy()
    np.testing.assert_allclose(back, tab_f, rtol=2.0**-15)


@pytest.mark.parametrize("variant", range(ps.ABLATE_VARIANTS))
def test_ablate_step_16(ablate_data, variant):
    """v0-v4 at G = 2 programs, two step counts; v3 and v4 feed the lanes'
    OR of hits back into the chain."""
    tab_f, nxt, tab_i = ablate_data
    ns = load_defs("exp_ablate_step", ("kern", "run"), R=R, P=P, G=2)
    for steps in (16, 48):
        out = np.asarray(ns["run"](jnp.asarray(nxt), jnp.asarray(tab_f), jnp.asarray(tab_i),
                                   steps=steps, variant=variant))
        got = ps.step_ablate(torch.from_numpy(nxt), torch.from_numpy(tab_f),
                             torch.from_numpy(tab_i), variant, steps, 2).numpy()
        assert got.shape == out.shape == (2, 8, P)
        if variant == 4:
            np.testing.assert_allclose(got, out, rtol=CHAIN_RTOL, atol=CHAIN_ATOL)
        else:
            assert_bits(got, out)


# --- the port's entry point, as a whole ---


def small(case):
    """A case of the entry point at R = 256, 16 and 48 steps, G = 2."""
    steps = (16, 48)[-len(case.steps):] if len(case.steps) > 1 else (32,)
    return dataclasses.replace(case, n_rows=R, steps=steps, programs=min(case.programs, 2))


def test_entry_point_runs_every_case_on_cpu(small_tables):
    """experiments/packet_step.py's cases, shrunk, on the CPU: every case of
    the seven scripts runs, and the wrapper (the plain version here) agrees
    with the plain version; no kernel is launched."""
    ps.reset_launches()
    rows = [eps.run_case(c, eps.make_inputs(c, "cpu", small_tables)) for c in map(small, eps.cases())]
    assert len({r["name"] for r in rows}) == len(eps.cases())
    assert {r["row"] for r in rows} == {"10", "11", "12", "13", "14", "15", "16"}
    assert ({r["kernel"] for r in rows} | {r["chain_kernel"] for r in rows if "chain_kernel" in r}
            == set(ps.KERNELS))
    for r in rows:
        assert r["ok"], r["name"]
        assert np.isfinite(r["ns_per_step"]) and r["bytes"] > 0 and r["bound_ms"] > 0
        assert eps.format_line(r).startswith(f"  {r['name']}")
    assert sum(ps.launch_counts().values()) == 0
    assert {r["launches"] for r in rows} == {0}
    # The slab chases that walk a chain, and row 15, also time the chain
    # alone (row 15's with a kernel of its own).
    for r in rows:
        walks = (r["kernel"] == "packet_slab_chase" and r["variant"] in ("slab", "slab_stack")
                 or r["kernel"] == "step_attrib")
        assert ("chain_ms" in r) == walks, r["name"]
        assert r.get("chain_launches", 0) == 0
    assert [len(r["marginal_ns"]) for r in rows if r["row"] == "10"] == [1]


def test_entry_point_inputs_are_the_scripts(data):
    """make_inputs draws the reference scripts' arrays: at R = 256 the
    entry point's row 10 inputs are this module's (and so the scripts')."""
    case = dataclasses.replace(eps.cases()[0], n_rows=R)
    x = eps.make_inputs(case, "cpu")
    assert_bits(x["table"].numpy(), data["tabT"])
    assert_bits(x["nxt"].numpy(), data["nxt"])
    assert_bits(x["rays"].numpy(), data["rays"])


def test_kernel_ab_rows_name_entry_point_cases():
    """kernel_ab.py's kernel-table rows 10-16 carry cases the entry point
    runs, of the kernel they name."""
    from shimmer_tpu_torch.experiments import kernel_ab

    by_name = {c.name: c for c in eps.cases()}
    assert sorted(kernel_ab.PACKET_ROWS) == [str(r) for r in range(10, 17)]
    for row, (kernel, case, _) in kernel_ab.PACKET_ROWS.items():
        assert by_name[case].row == row and by_name[case].kernel == kernel


@pytest.fixture(scope="module")
def small_tables():
    from shimmer_tpu_torch import bench_scene
    scene, _, _ = bench_scene.build_bench_scene(1280, (16, 8), device="cpu")
    t = scene.triangles
    return t.rows8, t.meta, t.stack_depth
