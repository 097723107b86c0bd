"""The port's row gathers (shimmer_tpu_torch/ops/gather.py) against the
reference's Pallas gather experiments, run in interpret mode on the CPU:
every TPU function of kernel-table rows 6-9 (experiments/pallas_gather.py
6B, 6B2, 6C, 6D, 6E; pallas_gather2.py 7F (both kernels), 7G;
exp_pallas_gather.py make_take, make_scalar; exp_pallas_gather2.py
make_scalar, make_scalar_reduce, make_taa), and the port's entry point
(shimmer_tpu_torch/experiments/gather.py) as a whole.

The reference scripts are run as they are, without editing them:

* pallas_gather.py and pallas_gather2.py are imported by path, with their
  module's ``pl`` replaced by a namespace whose ``pallas_call`` runs in
  interpret mode and records each call's inputs and output (through a
  host callback, since the calls sit inside ``jax.jit``), and their
  ``honest`` by one call at the unperturbed arguments;
* exp_pallas_gather.py and exp_pallas_gather2.py run their TPU benchmark
  when imported, so only their imports and the named kernel and
  ``make_*`` definitions are executed, in a namespace with small R, W, N
  and the same interpret-mode ``pl``.

The same numpy arrays go to both sides.  Tolerances: the gathers
bit-equal (they only move values).  The chases (6B, 6B2, 6C, 6E, 7F),
6D and the gather-sum rtol 1e-5: JAX sums ``row[1:9]`` and reduces rows
in its own order, the port left to right or by torch's tree, so the sums
differ by a few float32 roundings of their partial sums; a row read from
the wrong index moves a lane by O(1).
"""

import dataclasses
import importlib.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shimmer_tpu_torch.experiments import gather as eg
from shimmer_tpu_torch.ops import gather as g
from torch_parity import EXPERIMENTS, interpret_pl, load_defs

torch.set_num_threads(1)

W = 128
RTOL = 1e-5
# Chase sums of up to 8 K unit-normal terms: a few roundings of partial
# sums of magnitude <= ~100 in absolute terms.
CHASE_ATOL = 1e-4


def once(f, make_args, reps=3, warmup=1):
    """``honest`` replaced: one call at the unperturbed arguments."""
    jax.block_until_ready(f(*make_args(0)))
    return 0.0, 0.0


def load_script(name, records):
    spec = importlib.util.spec_from_file_location(f"reference_{name}", EXPERIMENTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = interpret_pl(records)
    mod.honest = once
    mod.report = lambda *a, **k: None
    return mod


def chase_table(rng, n_rows, width=W):
    """The reference's chase table: standard normal, column 0 row indices."""
    tab = rng.standard_normal((n_rows, width)).astype(np.float32)
    tab[:, 0] = rng.integers(0, n_rows, n_rows).astype(np.float32)
    return tab


def port_chase(tab, idx, steps):
    return g.row_chase(torch.from_numpy(tab), torch.from_numpy(idx), steps).numpy()


def assert_chase_close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=CHASE_ATOL)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    tab = chase_table(rng, 64)
    idx = rng.integers(0, 64, 256).astype(np.int32)
    return tab, idx


# --- experiments/pallas_gather.py ---


@pytest.mark.parametrize("fn", ["bench_pallas_vmem_take", "bench_pallas_vmem_take_cols"])
def test_chase_6b(inputs, fn):
    """6B (jnp.take in VMEM) and 6B2 (nine column takes): the K=32 chase."""
    tab, idx = inputs
    records = []
    mod = load_script("pallas_gather", records)
    getattr(mod, fn)(jnp.asarray(tab), jnp.asarray(idx), K=32)
    (rec,) = records
    np.testing.assert_array_equal(rec[0], idx)
    assert_chase_close(port_chase(tab, idx, 32), rec[-1])


@pytest.mark.parametrize("n_rows", [64, 512], ids=["in_range", "bf16_index_rounds_to_R"])
def test_onehot_chase_6c(n_rows):
    """6C: the chase over the bf16-rounded table (one-hot MXU product).
    At R=512, column 0 values 511 round to 512 = R in bf16: the one-hot
    matches no row, the row is zeros and the chase goes on from 0; the
    port does the same."""
    rng = np.random.default_rng(1)
    tab = chase_table(rng, n_rows)
    idx = rng.integers(0, n_rows, 256).astype(np.int32)
    if n_rows == 512:
        tab[rng.random(n_rows) < 0.2, 0] = 511.0
    records = []
    mod = load_script("pallas_gather", records)
    mod.bench_pallas_onehot(jnp.asarray(tab), jnp.asarray(idx), K=8)
    (rec,) = records
    t_bf16 = torch.from_numpy(tab).to(torch.bfloat16)
    stats = {}
    g.row_chase_plain(t_bf16, torch.from_numpy(idx), 8, stats=stats)
    n_oob = int(stats["oob_lanes"].sum())
    if n_rows == 512:
        assert int(t_bf16[:, 0].float().max()) == n_rows
        assert n_oob > 0
    else:
        assert n_oob == 0
    got = g.row_chase(t_bf16, torch.from_numpy(idx), 8).numpy()
    assert_chase_close(got, rec[-1])


@pytest.mark.parametrize("indices", ["period_8", "random"])
def test_dma_6d(inputs, indices):
    """6D: per-row DMA, 8 in flight: sum over K=4 passes of T[idx_i, 1],
    added one scalar at a time; the port's value is 4 * gather_sum[1].

    The reference starts the copy of row i + 8 into ring slot i % 8 before
    it reads row i from that slot (pallas_gather.py:195-203).  In
    interpret mode a copy lands when it starts, so lane i reads row i + 8:
    the first 8 indices are never read and the last 8 are read twice.
    With indices of period 8 the two rows are the same and the reference
    computes the function it means; with random indices its value is the
    port's gather-sum over the shifted index list."""
    tab, idx = inputs
    if indices == "period_8":
        idx = np.tile(idx[:8], len(idx) // 8)
    records = []
    mod = load_script("pallas_gather", records)
    mod.bench_pallas_dma(jnp.asarray(tab), jnp.asarray(idx), K=4)
    (rec,) = records
    read = idx if indices == "period_8" else np.concatenate([idx[8:], idx[-8:]])
    got = 4 * g.row_gather_sum(torch.from_numpy(tab), torch.from_numpy(read))[1].item()
    np.testing.assert_allclose(got, rec[-1][0, 0], rtol=RTOL)


def test_scalar_rows_6e(inputs):
    """6E: one lane from index 0, K=4096 dependent scalar row fetches."""
    tab, _ = inputs
    records = []
    mod = load_script("pallas_gather", records)
    mod.bench_pallas_scalar_rows(jnp.asarray(tab), K=4096)
    (rec,) = records
    got = port_chase(tab, np.zeros(1, np.int32), 4096)[0]
    np.testing.assert_allclose(got, rec[-1][0, 0], rtol=RTOL)


# --- experiments/pallas_gather2.py ---


def test_take_along_axis0_7f():
    """7F: take_along_axis on axis 0, its single gather (bit-equal) and its
    K=32 chase, on the script's own rng(0) data at R=64."""
    records = []
    mod = load_script("pallas_gather2", records)
    mod.check_and_bench_taa0(64, K=32)
    gather_rec, chase_rec = records
    idx, tab, out = gather_rec
    got = g.row_gather(torch.from_numpy(tab), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, out)
    np.testing.assert_array_equal(chase_rec[1], tab)
    assert_chase_close(port_chase(tab, chase_rec[0], 32), chase_rec[-1])


def test_take_along_axis1_7g():
    """7G: the column gather on the transposed (W, R) table, bit-equal."""
    records = []
    mod = load_script("pallas_gather2", records)
    mod.check_and_bench_taa1(64)
    ((idx, tab_t, out),) = records
    got = g.row_gather_cols(torch.from_numpy(tab_t), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, out)


# --- experiments/exp_pallas_gather.py, exp_pallas_gather2.py ---

SMALL = {"R": 64, "W": W, "N": 512}
BLOCK = 128


@pytest.fixture(scope="module")
def gather_inputs():
    rng = np.random.default_rng(2)
    tab = rng.standard_normal((SMALL["R"], W)).astype(np.float32)
    idx = rng.integers(0, SMALL["R"], SMALL["N"]).astype(np.int32)
    return tab, idx


@pytest.mark.parametrize(
    "script,defs,make",
    [
        ("exp_pallas_gather", ("take_kernel", "make_take"), "make_take"),
        ("exp_pallas_gather", ("scalar_kernel", "make_scalar"), "make_scalar"),
        ("exp_pallas_gather2", ("scalar_kernel", "make_scalar"), "make_scalar"),
        ("exp_pallas_gather2", ("taa_kernel", "make_taa"), "make_taa"),
    ],
    ids=["8_make_take", "8_make_scalar", "9_make_scalar", "9_make_taa"],
)
def test_gather_8_9(gather_inputs, script, defs, make):
    """Rows 8 and 9: T[idx] by jnp.take, scalar dynamic slices or
    take_along_axis in blocks of 128 lanes, bit-equal to the port."""
    tab, idx = gather_inputs
    ns = load_defs(script, defs, **SMALL)
    out = np.asarray(ns[make](BLOCK)(jnp.asarray(idx), jnp.asarray(tab)))
    got = g.row_gather(torch.from_numpy(tab), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, out)


def test_gather_sum_9(gather_inputs):
    """Row 9 make_scalar_reduce: sum_i T[idx_i] over a sequential grid,
    against the port's gather-sum."""
    tab, idx = gather_inputs
    ns = load_defs("exp_pallas_gather2", ("scalar_reduce_kernel", "make_scalar_reduce"), **SMALL)
    out = np.asarray(ns["make_scalar_reduce"](BLOCK)(jnp.asarray(idx), jnp.asarray(tab)))[0]
    got = g.row_gather_sum(torch.from_numpy(tab), torch.from_numpy(idx)).numpy()
    scale = np.abs(tab[idx]).sum(0)
    assert (np.abs(got - out) <= RTOL * scale).all()


# --- the port's entry point, as a whole ---


def small(case, by=64):
    """A case of the entry point at 1/``by`` of its R, N and (6E) chain
    length, for the CPU."""
    return dataclasses.replace(
        case, n_rows=case.n_rows // by, n=max(1, case.n // by),
        steps=case.steps // by if case.row == "6E" else case.steps)


def test_entry_point_runs_every_case_on_cpu():
    """experiments/gather.py's cases at 1/64 of the reference sizes on the
    CPU: every case of the four scripts runs, and the wrapper (the plain
    version here) agrees with the plain version."""
    g.reset_launches()
    rows = [eg.run_case(c, *eg.make_inputs(c, "cpu")) for c in map(small, eg.cases())]
    assert len({r["name"] for r in rows}) == len(eg.cases())
    assert all(r["ok"] for r in rows)
    assert {r["kernel"] for r in rows} == set(eg.KERNELS)
    assert [r["N"] for r in rows if r["row"] == "6E"] == [1, 1]
    for r in rows:
        assert np.isfinite(r["checksum"]) and r["distinct_rows"] >= 1
        assert eg.format_line(r).startswith(f"  {r['name']}")
    # 6D's bound counts one sector of column 1 a row, not the whole rows
    # the kernel sums.
    for r in rows:
        if r["row"] == "6D":
            assert r["bytes"] == r["distinct_rows"] * eg.SECTOR_BYTES + 4 * r["N"] + 4
    assert sum(g.launch_counts().values()) == 0


def test_entry_point_rows_match_reference_chase():
    """One case of the entry point's inputs through the reference's 6B
    kernel: the entry point's checksum is the JAX chase's sum."""
    case = eg.Case("6A/6B/6B2", "row_chase_f32", 64, 256, steps=32)
    table, idx = eg.make_inputs(case, "cpu")
    res = eg.run_case(case, table, idx)
    records = []
    mod = load_script("pallas_gather", records)
    mod.bench_pallas_vmem_take(jnp.asarray(table.numpy()), jnp.asarray(idx.numpy()), K=32)
    np.testing.assert_allclose(res["checksum"], records[0][-1].sum(), rtol=RTOL)

