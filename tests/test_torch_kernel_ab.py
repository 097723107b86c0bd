"""The before/after timing entry point (shimmer_tpu_torch/experiments/
kernel_ab.py) and the measurement helpers it shares with chip_smoke.py
(shimmer_tpu_torch/measure.py) on the CPU: the statistics, the bench
batches at a small size, the ray layouts, the traversal bound, the ptxas
log reader and the A/B summary.  The timings themselves need the card."""

import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from shimmer_tpu_torch import measure
from shimmer_tpu_torch.bench_scene import build_bench_scene
from shimmer_tpu_torch.experiments import kernel_ab as ab

torch.set_num_threads(1)


@pytest.mark.parametrize(
    "steps, want",
    [([3] * 32, 1.0), ([32] + [0] * 31, 1.0 / 32), ([4] * 32 + [2] * 32, 1.0),
     ([8] * 32 + [1], (8 * 32 + 1) / (32 * 9))],
    ids=["even", "one_lane", "two_warps", "ragged"],
)
def test_simd_efficiency(steps, want):
    got = measure.simd_efficiency(torch.tensor(steps, dtype=torch.int32))
    assert got == pytest.approx(want, rel=1e-12)


def test_step_stats_match_numpy():
    rng = np.random.default_rng(0)
    steps = rng.integers(0, 60, 1000).astype(np.int32)
    live = rng.random(1000) < 0.7
    got = measure.step_stats(torch.from_numpy(steps), torch.from_numpy(live))
    s = steps[live].astype(np.float64)
    assert got["steps_mean"] == pytest.approx(s.mean())
    assert got["steps_p50"] == pytest.approx(np.quantile(s, 0.5))
    assert got["steps_p99"] == pytest.approx(np.quantile(s, 0.99))
    assert got["steps_max"] == s.max()
    assert 0 < got["simd_efficiency"] <= 1


@pytest.fixture(scope="module")
def small_batches():
    scene, cam, film = build_bench_scene(320, (8, 8), device="cpu")
    block = measure.BLOCK
    measure.BLOCK = 64  # the 8x8 film is one block of 64 pixels
    try:
        return scene, measure.bench_batches(scene, cam, film, torch.device("cpu"))
    finally:
        measure.BLOCK = block


def test_bench_batches_small(small_batches):
    _, batches = small_batches
    assert list(batches) == ["primary", "bounce", "merged"]
    for name, (o, d, t_max, want) in batches.items():
        n = 128 if name == "merged" else 64
        assert o.shape == d.shape == (n, 3) and t_max.shape == want.shape == (n,)
        assert want.dtype == torch.bool and o.is_contiguous() and d.is_contiguous()
        assert torch.isfinite(o).all() and torch.isfinite(d).all()
    o, d, t_max, want = batches["merged"]
    # Extension rays, then shadow rays (any hit, t_max just short of the
    # light), some of each dead.
    assert not want[:64].any() and want[64:].all()
    assert set(t_max[64:].unique().tolist()) <= {-np.inf, np.float32(1.0 - 1e-3)}
    assert (t_max[:64] <= 0).any() and (t_max[64:] <= 0).any()


def test_layouts_sort_live_rays_first(small_batches):
    scene, batches = small_batches
    o, d, t_max, want = batches["merged"]
    lay = measure.layouts(scene.triangles, o, d, t_max, want)
    assert set(lay) == {"sorted", "unsorted"}
    s, u = lay["sorted"], lay["unsorted"]
    assert s[0] is scene.triangles.rows8 and u[3] is o
    live = s[5] > 0
    # A permutation of the same rays, live ones first.
    n_live = int(live.sum())
    assert live[:n_live].all() and not live[n_live:].any()
    key = lambda x, t: sorted(map(tuple, torch.cat([x, t[:, None]], 1).tolist()))  # noqa: E731
    assert key(s[3], s[5]) == key(u[3], u[5])


def _run(label, ms, checksum=1.5):
    line = {"ms": ms, "hits": 10, "t_checksum": checksum, "steps_mean": 4.0, "steps_p50": 4.0,
            "steps_p99": 9.0, "steps_max": 12, "simd_efficiency": 0.5, "bound_ms": ms / 40,
            "visits": 400, "internal_rows_read": 30, "leaf_rows_read": 20}
    return {"label": label, "card": "NVIDIA H100 80GB HBM3, 700.00 W",
            "traverse": {"v1 merged": {"sorted": line, "unsorted": dict(line, ms=2 * ms)}},
            "row_gather_cols": {"ms": ms / 10, "index_select_ms": 0.01,
                                "equal_to_index_select": True},
            "chase": {"10 make 131072": {"ms": 100 * ms, "checksum": checksum}}}


def test_summarize_pairs_a_and_b(tmp_path):
    paths = []
    for label, ms in (("A1", 0.4), ("B1", 0.2), ("B2", 0.3), ("A2", 0.6)):
        paths.append(tmp_path / f"{label}.json")
        paths[-1].write_text(json.dumps(_run(label, ms)))
    out = ab.summarize(paths)
    line = out["traverse"]["v1 merged sorted"]
    assert line["A"]["ms"] == pytest.approx(0.5) and line["B"]["ms"] == pytest.approx(0.25)
    assert line["B_over_A_ms"] == pytest.approx(0.5) and line["same_hits"]
    assert line["A"]["ms_runs"] == [0.4, 0.6]
    assert line["A"]["bound_ms"] == pytest.approx(0.5 / 40) and line["B"]["visits"] == 400
    assert out["traverse"]["v1 merged unsorted"]["B_over_A_ms"] == pytest.approx(0.5)
    assert out["row_gather_cols"]["B"]["ms"] == pytest.approx(0.025)
    chase = out["chase"]["10 make 131072"]
    assert chase["A"]["ms"] == pytest.approx(50.0) and chase["B"]["ms_runs"] == [20.0, 30.0]
    assert chase["B_over_A_ms"] == pytest.approx(0.5) and chase["same_output"]
    paths[1].write_text(json.dumps(_run("B1", 0.2, checksum=2.5)))
    out = ab.summarize(paths)
    assert not out["traverse"]["v1 merged sorted"]["same_hits"]
    assert not out["chase"]["10 make 131072"]["same_output"]


def test_run_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ab.run("B")


def test_ptxas_report_reads_each_kernel():
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115traverse_kernelILi1ELi0ELi0EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115traverse_kernelILi1ELi0ELi0EEEvNS_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, used 0 barriers, 480 bytes cmem[0]
ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'
ptxas info    : Function properties for _Z3fooPf
    256 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 1024 bytes smem, 360 bytes cmem[0]
"""
    got = measure.ptxas_report(log)
    assert [k["registers"] for k in got] == [72, 40]
    assert [(k["stack_frame"], k["spill_stores"], k["spill_loads"], k["smem"]) for k in got] == [
        (0, 0, 0, 0), (256, 8, 4, 1024)]
    # Demangled where c++filt is installed, the mangled name otherwise.
    assert got[0]["kernel"] in ("traverse_kernel<1, 0, 0>",
                                "_ZN12_GLOBAL__N_115traverse_kernelILi1ELi0ELi0EEEvNS_4ArgsE")


def test_kernel_ab_loads_measure_from_its_own_checkout():
    """kernel_ab times an older checkout on PYTHONPATH with this checkout's
    helpers: it loads measure.py by path, not through the package."""
    assert Path(ab.measure.__file__).resolve() == Path(measure.__file__).resolve()
    assert ab.measure is not measure


def test_traversal_bound_counts_the_launch_work():
    """Bytes of the rows and meta words the launch read plus the rays,
    operations of its visits; the larger time is the bound."""
    # Rows 0-1 internal, rows 2-3 leaves (count in the low bits of meta).
    tris = types.SimpleNamespace(meta=torch.tensor([2 << 4, 4 << 4, 3, 8], dtype=torch.int32))
    touched = torch.tensor([1, 0, 1, 1, 1, 1, 1, 0], dtype=torch.uint8)
    got = measure.traversal_bound(tris, touched, n_rays=10, visits=5)
    bytes_ = 1 * 7 * 32 + 2 * 9 * 32 + 3 * 4 + 10 * (29 + 8)
    assert (got["internal_rows_read"], got["leaf_rows_read"], got["meta_words_read"]) == (1, 2, 3)
    assert got["bytes"] == bytes_ and got["visits"] == 5
    assert got["bound_by"] == "bytes"
    assert got["bound_ms"] == pytest.approx(bytes_ / measure.HBM_BYTES_PER_S * 1e3)
    many = measure.traversal_bound(tris, touched, n_rays=10, visits=10**9)
    assert many["bound_by"] == "operations"
    assert many["bound_ms"] == pytest.approx(10**9 * 208 / measure.FP32_OPS_PER_S * 1e3)


def test_traversal_bound_counts_child_leaf_words():
    """v2 reads one child-leaf word per internal row it visits: 4 bytes
    each beside the rows and meta words; other launches read none."""
    tris = types.SimpleNamespace(meta=torch.tensor([2 << 4, 4 << 4, 3, 8], dtype=torch.int32))
    touched = torch.tensor([1, 1, 1, 0, 1, 1, 1, 0], dtype=torch.uint8)
    without = measure.traversal_bound(tris, touched, n_rays=10, visits=5)
    with_words = measure.traversal_bound(tris, touched, n_rays=10, visits=5, child_leaf=True)
    assert without["child_leaf_words_read"] == 0
    assert with_words["child_leaf_words_read"] == 2
    assert with_words["bytes"] == without["bytes"] + 2 * 4


def test_launch_kwargs_pass_child_leaf_words_where_tables_carry_them(small_batches):
    scene, _ = small_batches
    kw = measure.launch_kwargs(scene.triangles)
    assert list(kw) == ["child_leaf"] and kw["child_leaf"] is scene.triangles.child_leaf
    # An older checkout's table has no child-leaf words: its launch takes none.
    assert measure.launch_kwargs(types.SimpleNamespace(meta=scene.triangles.meta)) == {}


def test_time_chase_runs_the_entry_point_cases():
    """kernel_ab's chase cases are cases of the packet-step entry point at
    one of their step counts; on the CPU time_chase runs them through the
    wrapper (the plain versions) with their output checksums."""
    from shimmer_tpu_torch.experiments import packet_step as eps
    from shimmer_tpu_torch.ops import packet_step as ps

    by_name = {c.name: c for c in eps.cases()}
    for name, steps in ab.CHASE_CASES:
        assert steps in by_name[name].steps and by_name[name].kernel == "packet_slab_chase"
    ps.reset_launches()
    got = ab.time_chase(torch.device("cpu"))
    assert list(got) == [f"{name} {steps}" for name, steps in ab.CHASE_CASES]
    for (name, steps), line in zip(ab.CHASE_CASES, got.values()):
        case = by_name[name]
        x = eps.make_inputs(case, "cpu")
        want = ps.packet_slab_chase_plain(x["table"], x["nxt"], x["rays"], steps, case.variant,
                                          case.transposed)
        assert line["checksum"] == float(want.double().sum()) and line["ms"] > 0
    assert ps.launch_counts()["packet_slab_chase"] == 0


SCALAR_ROWS_CASE = "6E row_chase_f32 R=16384 N=1 W=128 K=4096"


def test_summarize_takes_the_parts_a_run_timed(tmp_path):
    """Runs of some parts only (``--parts attrib scalar_rows``): the summary
    has those sections and no others."""
    paths = []
    for label, ms, checksum in (("A1", 19.0, 1.0), ("B1", 0.05, 1.0), ("B2", 0.07, 1.0),
                                ("A2", 21.0, 1.0)):
        run = {"label": label, "card": "NVIDIA H100 80GB HBM3, 700.00 W",
               "parts": ["attrib", "scalar_rows"],
               "attrib": {"15 full step_attrib/full int32_min": {"ms": ms, "checksum": checksum}},
               "scalar_rows": {SCALAR_ROWS_CASE: {"ms": ms / 100, "checksum": checksum}}}
        paths.append(tmp_path / f"{label}.json")
        paths[-1].write_text(json.dumps(run))
    out = ab.summarize(paths)
    assert set(out) == {"cards", "attrib", "scalar_rows"}
    line = out["attrib"]["15 full step_attrib/full int32_min"]
    assert line["A"]["ms"] == pytest.approx(20.0) and line["B"]["ms"] == pytest.approx(0.06)
    assert line["B_over_A_ms"] == pytest.approx(0.003) and line["same_output"]
    assert out["scalar_rows"][SCALAR_ROWS_CASE]["B"]["ms_runs"] == pytest.approx([0.0005,
                                                                                    0.0007])


def test_time_attrib_and_scalar_rows_run_the_entry_point_cases(monkeypatch):
    """kernel_ab's row 15 and 6E timings on the CPU (the wrappers' plain
    versions), the entry points' cases shrunk: every variant from both
    stacks, with checksums of the outputs and stacks; the 6E case is the
    gather entry point's."""
    import dataclasses

    from shimmer_tpu_torch.experiments import gather as eg
    from shimmer_tpu_torch.experiments import packet_step as eps
    from shimmer_tpu_torch.ops import packet_step as ps

    cases, gather_cases = eps.cases(), eg.cases()
    monkeypatch.setattr(eps, "cases", lambda: [
        dataclasses.replace(c, steps=(8,), programs=2) for c in cases])
    monkeypatch.setattr(eg, "cases", lambda: [
        dataclasses.replace(c, steps=64) if c.row == "6E" else c for c in gather_cases])
    monkeypatch.setattr(ab, "ATTRIB_REPS", 1)
    scene, _, _ = build_bench_scene(320, (8, 8), device="cpu")
    t = scene.triangles
    ps.reset_launches()
    got = ab.time_attrib(torch.device("cpu"), (t.rows8, t.meta, t.stack_depth))
    assert list(got) == [f"15 {v} step_attrib/{v} {s}" for v in ps.ATTRIB_VARIANTS
                         for s in ("int32_min", "patterned")]
    assert all(line["ms"] > 0 and np.isfinite(line["checksum"]) for line in got.values())
    assert got["15 full step_attrib/full int32_min"]["checksum"] != got[
        "15 full step_attrib/full patterned"]["checksum"]
    assert sum(ps.launch_counts().values()) == 0
    rows = ab.time_scalar_rows(torch.device("cpu"))
    assert list(rows) == ["6E row_chase_f32 R=16384 N=1 W=128 K=64"]
    assert all(line["ms"] > 0 and np.isfinite(line["checksum"]) for line in rows.values())


def test_time_ablate_and_wide_chase_run_the_entry_point_cases(monkeypatch):
    """kernel_ab's row 16 and wide-chase timings on the CPU (the wrappers'
    plain versions), the entry points' cases shrunk: every ablation variant
    at both step counts and every chase case of more than one lane, with
    the checksums of the plain versions' outputs; no kernel launched."""
    import dataclasses

    from shimmer_tpu_torch.experiments import gather as eg
    from shimmer_tpu_torch.experiments import packet_step as eps
    from shimmer_tpu_torch.ops import gather as gk
    from shimmer_tpu_torch.ops import packet_step as ps

    cases, gather_cases = eps.cases(), eg.cases()
    monkeypatch.setattr(eps, "cases", lambda: [
        dataclasses.replace(c, n_rows=256, steps=(8, 24), programs=2) for c in cases])
    monkeypatch.setattr(eg, "cases", lambda: [
        dataclasses.replace(c, n_rows=c.n_rows // 64, n=max(1, c.n // 256)) for c in gather_cases])
    monkeypatch.setattr(ab, "ABLATE_REPS", 1)
    monkeypatch.setattr(ab, "WIDE_CHASE_REPS", 1)
    ps.reset_launches()
    gk.reset_launches()
    got = ab.time_ablate(torch.device("cpu"))
    assert list(got) == [f"16 v{v} step_ablate/v{v} {s}" for v in range(ps.ABLATE_VARIANTS)
                         for s in (8, 24)]
    for v in range(ps.ABLATE_VARIANTS):
        case = next(c for c in eps.cases() if c.variant == f"v{v}")
        x = eps.make_inputs(case, "cpu")
        for s in (8, 24):
            want = ps.step_ablate_plain(x["meta"], x["tab"], x["tab_i"], v, s, 2)
            line = got[f"{case.name} {s}"]
            assert line["checksum"] == float(want.double().sum()) and line["ms"] > 0
    chases = ab.time_wide_chase(torch.device("cpu"))
    wide = [c for c in eg.cases() if c.kernel.startswith("row_chase") and c.row != "6E"]
    assert list(chases) == [c.name for c in wide] and len(wide) == 19
    for case in wide:
        table, idx = eg.make_inputs(case, "cpu")
        want = gk.row_chase_plain(table, idx, case.steps)
        assert chases[case.name]["checksum"] == float(want.double().sum())
    assert sum(ps.launch_counts().values()) == 0 and sum(gk.launch_counts().values()) == 0
    assert {"ablate", "wide_chase"} <= set(ab.PARTS) and {"ablate", "wide_chase"} <= set(
        ab.TIMED_SECTIONS)


def test_time_gather_sum_runs_the_entry_point_cases(monkeypatch):
    """kernel_ab's gather-sum part on the CPU (the wrappers' plain
    versions), the cases shrunk: 6D through the one-column sum, row 9
    through the whole-row sum, each checksum beside its float64 sum; on a
    checkout without the one-column sum, 6D as 4 * row_gather_sum(...)[1]
    on the same inputs.  No kernel launched."""
    from shimmer_tpu_torch.experiments import gather as eg
    from shimmer_tpu_torch.ops import gather as gk

    monkeypatch.setattr(ab, "GATHER_SUM_CASES", (("6D", 64, 8192), ("9", 256, 4096),
                                                 ("9", 64, 8192)))
    gk.reset_launches()
    got = ab.time_gather_sum(torch.device("cpu"))
    assert list(got) == ["6D R=64 N=8192", "9 R=256 N=4096", "9 R=64 N=8192"]
    for name, line in got.items():
        assert line["ms"] > 0
        assert line["checksum"] == pytest.approx(line["exact"], rel=eg.SUM_RTOL, abs=1e-3)
    case = eg.Case("6D", "row_gather_col_sum", 64, 8192, steps=4)
    table, idx = eg.make_inputs(case, "cpu")
    assert got["6D R=64 N=8192"]["checksum"] == float(gk.row_gather_col_sum(table, idx, 1, 4))
    case = eg.Case("9", "row_gather_sum", 256, 4096, index_col=False)
    table9, idx9 = eg.make_inputs(case, "cpu")
    assert got["9 R=256 N=4096"]["checksum"] == float(
        gk.row_gather_sum(table9, idx9).double().sum())
    monkeypatch.delattr(gk, "row_gather_col_sum")
    older = ab.time_gather_sum(torch.device("cpu"))
    assert older["6D R=64 N=8192"]["checksum"] == float(4 * gk.row_gather_sum(table, idx)[1])
    assert sum(gk.launch_counts().values()) == 0
    assert "gather_sum" in ab.PARTS and "gather_sum" in ab.TIMED_SECTIONS


def test_summarize_gather_sum_part(tmp_path):
    """Runs of ``--parts gather_sum``: the summary holds the 6D and row 9
    lines with their A and B means and B / A, and only that section."""
    paths = []
    for label, ms, checksum in (("A1", 0.0133, 2.5), ("B1", 0.005, 2.5), ("B2", 0.006, 2.5),
                                ("A2", 0.0135, 2.5)):
        run = {"label": label, "card": "NVIDIA H100 80GB HBM3, 700.00 W", "parts": ["gather_sum"],
               "gather_sum": {name: {"ms": ms, "checksum": checksum, "exact": 2.5}
                              for name in ("6D R=16384 N=8192", "9 R=16384 N=131072")}}
        paths.append(tmp_path / f"{label}.json")
        paths[-1].write_text(json.dumps(run))
    out = ab.summarize(paths)
    assert set(out) == {"cards", "gather_sum"}
    line = out["gather_sum"]["6D R=16384 N=8192"]
    assert line["A"]["ms"] == pytest.approx(0.0134) and line["B"]["ms"] == pytest.approx(0.0055)
    assert line["B_over_A_ms"] == pytest.approx(0.0055 / 0.0134) and line["same_output"]
    assert line["B"]["ms_runs"] == [0.005, 0.006]


def test_time_gather_sum_grid_covers_the_rule(monkeypatch):
    """kernel_ab's grid of the gather-sum's rule on the CPU (the plain
    version), shrunk: one line per (W, R, N), each checksum the plain sum's;
    the full grid holds the entry point's row-9 sizes and both sides of
    every bound of the rule."""
    from shimmer_tpu_torch.ops import gather as gk

    full = ab.GATHER_SUM_GRID
    sizes = {(w, r, n) for w, rows, lanes in full for r in rows for n in lanes}
    assert (128, 16384, 131072) in sizes and (128, 16384, 8192) in sizes
    for w, r, n in sizes:
        # Every size the rule sends counted has a direct neighbour in N.
        if gk.gather_sum_counted(r, n, w):
            assert any(not gk.gather_sum_counted(r, m, w) for ww, rr, m in sizes
                       if (ww, rr) == (w, r))
    assert any(gk.gather_sum_counted(r, n, w) for w, r, n in sizes)
    assert {w for w, _, _ in sizes} == {8, gk.SUM_COUNTED_MIN_WIDTH}
    monkeypatch.setattr(ab, "GATHER_SUM_GRID", ((8, (64,), (16, 100)), (128, (32,), (8,))))
    gk.reset_launches()
    got = ab.time_gather_sum_grid(torch.device("cpu"))
    assert list(got) == ["W=8 R=64 N=16", "W=8 R=64 N=100", "W=128 R=32 N=8"]
    assert all(line["ms"] > 0 and np.isfinite(line["checksum"]) for line in got.values())
    assert sum(gk.launch_counts().values()) == 0
