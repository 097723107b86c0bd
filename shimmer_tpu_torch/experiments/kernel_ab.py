"""Kernel times of one checkout of the port on the bench batches, for a
before/after comparison of two checkouts on one card.

Builds the bench scene and its 1.3M-triangle leg, makes the traversal
batches tests/test_torch_traverse_card.py holds the kernels to
(shimmer_tpu_torch/measure.py, ``bench_batches``), and times, on the card:

* each v1 template (v1, v1_mt, v1_min) and v2 on the bounce and merged
  bench batches, rays sorted as the wrapper lays them out and unsorted;
* v1 and v2 on the large table's merged batch, sorted and unsorted;
* the transposed row gather (kernel-table row 7G) on the gather entry
  point's case, with ``torch.index_select`` beside it;
* the packet slab chase (kernel-table rows 10, 12 and 13) on the
  packet-step entry point's cases: row 10 at 131,072 steps, row 13 A, B
  and empty at 262,144, row 12 A at 512;
* the step attribution (row 15) in all six variants at the packet-step
  entry point's case (G = 64 programs of K = 2 packets, 256 steps, the
  bench BVH8), from interpret mode's INT32_MIN stack as the case runs it
  and from a seeded patterned stack whose chain walks the table;
* the one-lane row chase 6E (R = 16,384, N = 1, K = 4,096) on the gather
  entry point's case;
* the step ablation (row 16), v0-v4 at 256 and 2,048 steps, G = 64, on
  the packet-step entry point's case (``ablate``);
* every wide row chase of the gather entry point (6A/6B/6B2, 6C, the 7F
  chase and 7H at their sizes: every chase case but 6E's one lane;
  ``wide_chase``);
* the gather-sums of the gather entry point (``gather_sum``): 6D, ``4 *
  sum_i T[idx_i, 1]`` at R = 2,048 and 16,384 (N = 8,192), by
  ``ops.gather.row_gather_col_sum`` where the checkout has it and else as
  ``4 * row_gather_sum(...)[1]``, as the port computed it before; row 9's
  ``row_gather_sum`` at R = 16,384, N = 131,072, and at 6D's sizes;
* ``row_gather_sum`` over the grid of (W, R, N) that its rule between the
  direct and counted forms was set on (``gather_sum_grid``: run it on
  snapshots with the rule forced each way to time the forms);

with each traversal's visits per live ray, SIMD efficiency in launch order,
its bound from the rows and visits of its own launch, and a checksum of its
hits (equal checksums: the same t on the same lanes), each chase's output
checksum (a gather-sum's beside its float64 sum, ``exact``), and the registers, stack frame and spills of each kernel it
builds.  It uses only entry points that the port has offered since before
the v1 redesign (``ops.traverse._launch_kernel`` with ``touched``,
``ops.gather.row_gather_cols``, ``ops.gather.row_chase``,
``ops.packet_step.packet_slab_chase``, ``ops.packet_step.step_attrib``,
``ops.packet_step.step_ablate``, the scene builders and the entry points'
case tables and inputs), passing the child-leaf
words v2 reads where the checkout's tables carry them
(``measure.launch_kwargs``), and loads measure.py from its own checkout by
path, so the same file times an older checkout: run it with that
checkout's root as the working directory and on ``PYTHONPATH``,
alternating the two checkouts (A B B A), each run writing its own file,
then summarise:

    PYTHONPATH=$PWD python3 /path/to/kernel_ab.py --label A1 --out ab_A1.json
    python3 kernel_ab.py --summarize ab_A1.json ab_B1.json ab_B2.json ab_A2.json

``--parts`` times only some of it (``PARTS``; the bench scene is built
only for the traversal and row 15), e.g. ``--parts ablate wide_chase``.

Needs a CUDA card; the summary does not.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch


def _load_measure():
    """shimmer_tpu_torch/measure.py of this file's checkout, by path (an
    older checkout on PYTHONPATH may not have it)."""
    path = Path(__file__).resolve().parents[1] / "measure.py"
    spec = importlib.util.spec_from_file_location("_kernel_ab_measure", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


measure = _load_measure()

REPS = 20
AB_CONFIGS = ("v1", "v1_mt", "v1_min", "v2")
LARGE_CONFIGS = ("v1", "v2")
COLS_CASE = "7G row_gather_cols R=8192 N=8192 W=128 K=1"
# Packet slab chase cases of the packet-step entry point, and the steps
# each is timed at (row 12 A: the shortest chain); the parent's kernel
# takes 95-191 ms a launch on rows 10 and 13.
CHASE_CASES = (("10 make packet_slab_chase/slab transposed", 131072),
               ("13 A roll packet_slab_chase/slab transposed", 262144),
               ("13 B mxu/C xpose/D scalar packet_slab_chase/slab", 262144),
               ("13 empty packet_slab_chase/empty", 262144),
               ("12 A roll packet_slab_chase/slab transposed", 512))
CHASE_REPS = 3
# Row 15's timed launches per variant and stack (the kernel before its
# redesign took 19 ms a launch).
ATTRIB_REPS = 5
# 6E's case of the gather entry point: one lane, R = 16,384 (K = 4,096).
SCALAR_ROWS_R = 16384
# Row 16's timed launches per variant and step count (the kernel before
# its redesign took 0.9-1.5 ms a launch at 2,048 steps), and the wide
# chases'.
ABLATE_REPS = 10
WIDE_CHASE_REPS = 20
# The gather-sum cases (row, R, N) of the gather entry point: 6D's one
# column (4 passes over column 1) and row 9's whole-row sum.
GATHER_SUM_CASES = (("6D", 2048, 8192), ("6D", 16384, 8192), ("9", 16384, 131072),
                    ("9", 2048, 8192), ("9", 16384, 8192))
# The grid of the gather-sum's rule: (W, R values, N values), on tables and
# indices drawn on the card (torch's generator, seeded by the sizes).
GATHER_SUM_GRID = ((128, (2048, 16384, 131072, 1048576),
                    (1024, 8192, 16384, 32768, 65536, 131072, 524288)),
                   (8, (2048, 16384, 131072), (1024, 8192, 32768, 131072)))
PARTS = ("traverse", "cols", "chase", "attrib", "scalar_rows", "ablate", "wide_chase",
         "gather_sum", "gather_sum_grid")
# The sections of a run that are {measurement: {"ms", "checksum"}}.
TIMED_SECTIONS = ("chase", "attrib", "scalar_rows", "ablate", "wide_chase", "gather_sum",
                  "gather_sum_grid")
# Per traversal layout: what the summary averages over the runs of a side.
SUMMARY_KEYS = ("ms", "steps_mean", "steps_p50", "steps_p99", "steps_max", "simd_efficiency",
                "bound_ms", "visits", "internal_rows_read", "leaf_rows_read")
# The packet-step kernels of rows 10-16 (csrc/packet_step.cu) -> (kernel,
# the packet-step entry point's case whose times the row carries, the TPU
# function it ports).
PACKET_ROWS = {
    "10": ("packet_slab_chase", "10 make packet_slab_chase/slab transposed",
           "experiments/exp_scaling.py:38 (make; pallas_call :47)"),
    "11": ("packet_slab_chase", "11 step_kernel packet_slab_chase/slab_stack transposed",
           "experiments/exp_packet_step.py:40 (step_kernel; pallas_call :87)"),
    "12": ("packet_slab_chase", "12 A roll packet_slab_chase/slab transposed",
           "experiments/exp_packet_step2.py:65 (make, fetch A-D; pallas_call :66)"),
    "13": ("packet_slab_chase", "13 A roll packet_slab_chase/slab transposed",
           "experiments/exp_fetch_honest.py:82 (make, empty and A-D; pallas_call :92)"),
    "14": ("packet_slab_chase", "14 k6 fetch+slab while packet_slab_chase/slab transposed",
           "experiments/exp_loop_overhead.py:57 (make, k1-k6; pallas_call :58)"),
    "15": ("step_attrib", "15 full step_attrib/full",
           "experiments/exp_step_attrib.py:43 (kern; pallas_call :208)"),
    "16": ("step_ablate", "16 v4 step_ablate/v4",
           "experiments/exp_ablate_step.py:32 (kern; run :127, pallas_call :128)"),
}


def time_traversal(tris, batch) -> dict:
    from shimmer_tpu_torch.ops import traverse as tv

    cfg = tris.traverse
    kw = measure.launch_kwargs(tris)
    out = {}
    for name, args in measure.layouts(tris, *batch).items():
        t, tri, _ = tv._launch_kernel(*args, False, cfg, **kw)
        closest = (tri >= 0) & ~args[6]
        bound, stats = measure.launch_bound(tris, args, cfg)
        out[name] = {
            "ms": measure.cuda_ms(lambda: tv._launch_kernel(*args, False, cfg, **kw), REPS),
            "hits": int((tri >= 0).sum()),
            "t_checksum": float(t[closest].double().sum()),
            **stats,
            **bound,
        }
    return out


def time_chase(dev) -> dict:
    """Each of CHASE_CASES on the entry point's own inputs: ms (the entry
    point's timer) and the output's checksum."""
    from shimmer_tpu_torch.experiments import gather as eg
    from shimmer_tpu_torch.experiments import packet_step as eps
    from shimmer_tpu_torch.ops import packet_step as ps

    by_name = {c.name: c for c in eps.cases()}
    out = {}
    for name, steps in CHASE_CASES:
        case = by_name[name]
        x = eps.make_inputs(case, dev)

        def chase():
            return ps.packet_slab_chase(x["table"], x["nxt"], x["rays"], steps, case.variant,
                                        case.transposed)

        out[f"{name} {steps}"] = {"ms": eg.time_ms(chase, dev, reps=CHASE_REPS),
                                  "checksum": float(chase().double().sum())}
    return out


def time_attrib(dev, tables) -> dict:
    """Row 15, each variant at the packet-step entry point's case, from the
    case's INT32_MIN stack and from a patterned one: ms and the checksum of
    the output and the final stacks."""
    from shimmer_tpu_torch.experiments import gather as eg
    from shimmer_tpu_torch.experiments import packet_step as eps
    from shimmer_tpu_torch.ops import packet_step as ps

    out = {}
    for case in eps.cases():
        if case.kernel != "step_attrib":
            continue
        x = eps.make_inputs(case, dev, tables)
        size, n_rows, k = x["stack_size"], x["meta"].shape[0], eps.ATTRIB_PACKETS
        stacks = {
            "int32_min": torch.full((k, size), ps.INT32_MIN, dtype=torch.int32, device=dev),
            "patterned": measure.patterned_stack(n_rows, k, size, eps.SEED + 1).to(dev),
        }
        for stack_name, init in stacks.items():
            def attrib(init=init):
                return ps.step_attrib(x["rows8"], x["meta"], x["rays"], case.variant,
                                      case.steps[-1], k, size, init)

            got, st = attrib()
            out[f"{case.name} {stack_name}"] = {
                "ms": eg.time_ms(attrib, dev, reps=ATTRIB_REPS),
                "checksum": float(got.double().sum()) + float(st.double().sum())}
    return out


def time_scalar_rows(dev) -> dict:
    """6E, the one-lane chase, on the gather entry point's case."""
    from shimmer_tpu_torch.experiments import gather as eg
    from shimmer_tpu_torch.ops import gather as gk

    case = next(c for c in eg.cases() if c.row == "6E" and c.n_rows == SCALAR_ROWS_R)
    table, idx = eg.make_inputs(case, dev)
    got = gk.row_chase(table, idx, case.steps)
    return {case.name: {
        "ms": eg.time_ms(lambda: gk.row_chase(table, idx, case.steps), dev),
        "checksum": float(got.double().sum())}}


def time_ablate(dev) -> dict:
    """Row 16, each variant at each step count of the packet-step entry
    point's case (G = 64 programs on its seeded table): ms and the
    output's checksum."""
    from shimmer_tpu_torch.experiments import gather as eg
    from shimmer_tpu_torch.experiments import packet_step as eps
    from shimmer_tpu_torch.ops import packet_step as ps

    calls = {}
    for case in eps.cases():
        if case.kernel != "step_ablate":
            continue
        x = eps.make_inputs(case, dev)
        for steps in case.steps:
            def ablate(x=x, v=int(case.variant[1:]), steps=steps, g=case.programs):
                return ps.step_ablate(x["meta"], x["tab"], x["tab_i"], v, steps, g)

            calls[f"{case.name} {steps}"] = ablate
    for ablate in calls.values():  # every kernel loaded and the card busy first
        ablate()
    return {name: {"ms": eg.time_ms(ablate, dev, reps=ABLATE_REPS),
                   "checksum": float(ablate().double().sum())} for name, ablate in calls.items()}


def wide_chase_cases() -> list:
    """The gather entry point's chase cases of more than one lane."""
    from shimmer_tpu_torch.experiments import gather as eg

    return [c for c in eg.cases() if c.kernel.startswith("row_chase") and c.row != "6E"]


def time_wide_chase(dev) -> dict:
    """Each wide chase of the gather entry point on its own inputs: ms and
    the output's checksum."""
    from shimmer_tpu_torch.experiments import gather as eg
    from shimmer_tpu_torch.ops import gather as gk

    out = {}
    for case in wide_chase_cases():
        table, idx = eg.make_inputs(case, dev)
        got = gk.row_chase(table, idx, case.steps)
        out[case.name] = {
            "ms": eg.time_ms(lambda: gk.row_chase(table, idx, case.steps), dev,
                             reps=WIDE_CHASE_REPS),
            "checksum": float(got.double().sum())}
    return out


def gather_sum_calls(dev) -> dict:
    """{name: (call, float64 value)} of GATHER_SUM_CASES on the gather entry
    point's inputs (its table and indices for the same sizes)."""
    from shimmer_tpu_torch.experiments import gather as eg
    from shimmer_tpu_torch.ops import gather as gk

    calls = {}
    for row, n_rows, n in GATHER_SUM_CASES:
        # The entry point's cases at N = 8,192 hold row indices in column 0.
        case = eg.Case(row, "row_gather_sum", n_rows, n, index_col=n == 8192)
        table, idx = eg.make_inputs(case, dev)
        rows = table[idx.long()].double()
        if row == "9":
            calls[f"{row} R={n_rows} N={n}"] = (lambda t=table, i=idx: gk.row_gather_sum(t, i),
                                                float(rows.sum()))
        elif hasattr(gk, "row_gather_col_sum"):
            calls[f"{row} R={n_rows} N={n}"] = (
                lambda t=table, i=idx: gk.row_gather_col_sum(t, i, 1, 4), float(4 * rows[:, 1].sum()))
        else:
            calls[f"{row} R={n_rows} N={n}"] = (
                lambda t=table, i=idx: 4 * gk.row_gather_sum(t, i)[1], float(4 * rows[:, 1].sum()))
    return calls


def time_gather_sum(dev) -> dict:
    """Each of GATHER_SUM_CASES through the checkout's wrappers: ms (the
    entry point's timer), the output's checksum and its float64 sum."""
    from shimmer_tpu_torch.experiments import gather as eg

    calls = gather_sum_calls(dev)
    for call, _ in calls.values():  # every kernel loaded and the card busy first
        call()
    return {name: {"ms": eg.time_ms(call, dev), "checksum": float(call().double().sum()),
                   "exact": exact} for name, (call, exact) in calls.items()}


def time_gather_sum_grid(dev) -> dict:
    """row_gather_sum at each (W, R, N) of GATHER_SUM_GRID: ms and the
    output's checksum."""
    from shimmer_tpu_torch.experiments import gather as eg
    from shimmer_tpu_torch.ops import gather as gk

    out = {}
    for width, rows, lanes in GATHER_SUM_GRID:
        for n_rows in rows:
            gen = torch.Generator(device=dev).manual_seed(n_rows * width)
            table = torch.randn(n_rows, width, generator=gen, device=dev)
            for n in lanes:
                idx = torch.randint(0, n_rows, (n,), generator=gen, device=dev,
                                    dtype=torch.int32)
                out[f"W={width} R={n_rows} N={n}"] = {
                    "ms": eg.time_ms(lambda: gk.row_gather_sum(table, idx), dev),
                    "checksum": float(gk.row_gather_sum(table, idx).double().sum())}
            del table
    return out


def run(label: str, parts=PARTS) -> dict:
    """One checkout's timings of ``parts`` (PARTS) on the card."""
    from shimmer_tpu_torch.bench_scene import BENCH_RESOLUTION, BENCH_TRIS, build_bench_scene
    from shimmer_tpu_torch.ops import cuda_build

    if not torch.cuda.is_available():
        raise RuntimeError("kernel_ab needs a CUDA card; none is available")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    build = cuda_build.build(("traverse", "gather", "packet_step"), force=True)
    res = {"label": label, "card": smi, "parts": list(parts),
           "ptxas": {name: measure.ptxas_report(b["log"]) for name, b in build.items()}}
    if "traverse" in parts or "attrib" in parts:
        scene_cpu, cam, film = build_bench_scene(BENCH_TRIS, BENCH_RESOLUTION, device="cpu")
        scene = scene_cpu.to(dev)
        del scene_cpu
        tris = scene.triangles
        if "attrib" in parts:
            res["attrib"] = time_attrib(dev, (tris.rows8, tris.meta, tris.stack_depth))
        if "traverse" in parts:
            res["traverse"] = traverse_part(scene, cam, film, dev)
        del scene, tris
        torch.cuda.empty_cache()
    if "cols" in parts:
        res["row_gather_cols"] = cols_part(dev)
    if "chase" in parts:
        res["chase"] = time_chase(dev)
    if "scalar_rows" in parts:
        res["scalar_rows"] = time_scalar_rows(dev)
    if "ablate" in parts:
        res["ablate"] = time_ablate(dev)
    if "wide_chase" in parts:
        res["wide_chase"] = time_wide_chase(dev)
    if "gather_sum" in parts:
        res["gather_sum"] = time_gather_sum(dev)
    if "gather_sum_grid" in parts:
        res["gather_sum_grid"] = time_gather_sum_grid(dev)
    res["seconds"] = time.perf_counter() - t0
    return res


def traverse_part(scene, cam, film, dev) -> dict:
    """The traversal timings: each configuration on the bench batches, then
    v1 and v2 on the large table's merged batch."""
    from shimmer_tpu_torch.bench_scene import BENCH_RESOLUTION, LARGE_TRIS, build_bench_scene
    from shimmer_tpu_torch.ops import traverse as tv

    out = {}
    configs = {name: tv.TraverseConfig(name[:2], "mt" if "mt" in name else "watertight",
                                       "min" if "min" in name else "slot")
               for name in AB_CONFIGS}
    batches = measure.bench_batches(scene, cam, film, dev)
    for name, cfg in configs.items():
        tris = scene.triangles.with_traverse(cfg)
        for bname in ("bounce", "merged"):
            out[f"{name} {bname}"] = time_traversal(tris, batches[bname])
    del batches
    torch.cuda.empty_cache()

    large_cpu, cam, film = build_bench_scene(LARGE_TRIS, BENCH_RESOLUTION, device="cpu")
    large = large_cpu.to(dev)
    del large_cpu
    merged = measure.bench_batches(large, cam, film, dev)["merged"]
    for name in LARGE_CONFIGS:
        out[f"{name} large merged"] = time_traversal(
            large.triangles.with_traverse(configs[name]), merged)
    del large, merged
    torch.cuda.empty_cache()
    return out


def cols_part(dev) -> dict:
    """The transposed row gather (7G) beside index_select."""
    from shimmer_tpu_torch.experiments import gather as eg
    from shimmer_tpu_torch.ops import gather as gk

    case = next(c for c in eg.cases() if c.name == COLS_CASE)
    table_t, idx = eg.make_inputs(case, dev)
    got = gk.row_gather_cols(table_t, idx)
    lib = torch.index_select(table_t, 1, idx)
    # The gather entry point's timer: launches queued behind a device-side
    # sleep, so that the host's launch cost stays out of a 10 us kernel.
    return {
        "case": COLS_CASE,
        "equal_to_index_select": bool(torch.equal(got, lib)),
        "ms": eg.time_ms(lambda: gk.row_gather_cols(table_t, idx), dev),
        "index_select_ms": eg.time_ms(lambda: torch.index_select(table_t, 1, idx), dev),
    }


def summarize(paths) -> dict:
    """Per measurement of the parts the runs timed: the mean of the runs
    labelled A* and of those labelled B*, and B / A; the hit and output
    checksums must agree between A and B."""
    runs = [json.load(open(p)) for p in paths]
    groups = {"A": [r for r in runs if r["label"].startswith("A")],
              "B": [r for r in runs if r["label"].startswith("B")]}
    out = {"cards": sorted({r["card"] for r in runs})}
    if "traverse" in runs[0]:
        out["traverse"] = {}
        for key in runs[0]["traverse"]:
            for layout in ("sorted", "unsorted"):
                rows = {g: [r["traverse"][key][layout] for r in rs] for g, rs in groups.items()}
                line = {}
                for g, rs in rows.items():
                    line[g] = {k: float(np.mean([r[k] for r in rs])) for k in SUMMARY_KEYS}
                    line[g]["ms_runs"] = [r["ms"] for r in rs]
                line["B_over_A_ms"] = line["B"]["ms"] / line["A"]["ms"]
                line["same_hits"] = len({(r["hits"], r["t_checksum"])
                                         for rs in rows.values() for r in rs}) == 1
                out["traverse"][f"{key} {layout}"] = line
    if "row_gather_cols" in runs[0]:
        cols = {g: [r["row_gather_cols"] for r in rs] for g, rs in groups.items()}
        out["row_gather_cols"] = {
            g: {"ms": float(np.mean([c["ms"] for c in cs])),
                "ms_runs": [c["ms"] for c in cs],
                "index_select_ms": float(np.mean([c["index_select_ms"] for c in cs])),
                "equal_to_index_select": all(c["equal_to_index_select"] for c in cs)}
            for g, cs in cols.items()
        }
    for section in TIMED_SECTIONS:
        if section not in runs[0]:
            continue
        out[section] = {}
        for key in runs[0][section]:
            line = {g: {"ms": float(np.mean([r[section][key]["ms"] for r in rs])),
                        "ms_runs": [r[section][key]["ms"] for r in rs]}
                    for g, rs in groups.items()}
            line["B_over_A_ms"] = line["B"]["ms"] / line["A"]["ms"]
            line["same_output"] = len({r[section][key]["checksum"] for r in runs}) == 1
            out[section][key] = line
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", help="run label: A... (before) or B... (after)")
    ap.add_argument("--out", help="write the run's JSON here")
    ap.add_argument("--parts", nargs="+", choices=PARTS, default=list(PARTS),
                    help="what to time (default: all)")
    ap.add_argument("--summarize", nargs="+", metavar="JSON", help="summarise runs instead")
    args = ap.parse_args(argv)
    if args.summarize:
        print(json.dumps(summarize(args.summarize), indent=1))
        return
    res = run(args.label or "B", tuple(args.parts))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f)
    print(json.dumps(res))


if __name__ == "__main__":
    sys.exit(main())
