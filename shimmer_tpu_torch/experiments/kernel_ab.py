"""Kernel times of one checkout of the port on the bench batches, for a
before/after comparison of two checkouts on one card.

Builds the bench scene and its 1.3M-triangle leg, makes the traversal
batches chip_smoke.py's phases 3 and 7 hold the kernels to
(shimmer_tpu_torch/measure.py, ``bench_batches``), and times, on the card:

* each v1 template (v1, v1_mt, v1_min) and v2 on the bounce and merged
  bench batches, rays sorted as the wrapper lays them out and unsorted;
* v1 and v2 on the large table's merged batch, sorted and unsorted;
* the transposed row gather (kernel-table row 7G) on the gather entry
  point's case, with ``torch.index_select`` beside it;
* the packet slab chase (kernel-table rows 10, 12 and 13) on the
  packet-step entry point's cases: row 10 at 131,072 steps, row 13 A, B
  and empty at 262,144, row 12 A at 512;

with each traversal's visits per live ray, SIMD efficiency in launch order,
its bound from the rows and visits of its own launch, and a checksum of its
hits (equal checksums: the same t on the same lanes), each chase's output
checksum, and the registers, stack frame and spills of each kernel it
builds.  It uses only entry points that the port has offered since before
the v1 redesign (``ops.traverse._launch_kernel`` with ``touched``,
``ops.gather.row_gather_cols``, ``ops.packet_step.packet_slab_chase``, the
scene builders and the entry points' case tables), passing the child-leaf
words v2 reads where the checkout's tables carry them
(``measure.launch_kwargs``), and loads measure.py from its own checkout by
path, so the same file times an older checkout: run it with that
checkout's root as the working directory and on ``PYTHONPATH``,
alternating the two checkouts (A B B A), each run writing its own file,
then summarise:

    PYTHONPATH=$PWD python3 /path/to/kernel_ab.py --label A1 --out ab_A1.json
    python3 kernel_ab.py --summarize ab_A1.json ab_B1.json ab_B2.json ab_A2.json

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
# Per traversal layout: what the summary averages over the runs of a side.
SUMMARY_KEYS = ("ms", "steps_mean", "steps_p50", "steps_p99", "steps_max", "simd_efficiency",
                "bound_ms", "visits", "internal_rows_read", "leaf_rows_read")


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


def run(label: str) -> dict:
    from shimmer_tpu_torch.bench_scene import (
        BENCH_RESOLUTION,
        BENCH_TRIS,
        LARGE_TRIS,
        build_bench_scene,
    )
    from shimmer_tpu_torch.experiments import gather as eg
    from shimmer_tpu_torch.ops import cuda_build
    from shimmer_tpu_torch.ops import gather as gk
    from shimmer_tpu_torch.ops import traverse as tv

    if not torch.cuda.is_available():
        raise RuntimeError("kernel_ab needs a CUDA card; none is available")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    build = cuda_build.build(("traverse", "gather", "packet_step"), force=True)
    res = {"label": label, "card": smi,
           "ptxas": {name: measure.ptxas_report(b["log"]) for name, b in build.items()},
           "traverse": {}}
    configs = {name: tv.TraverseConfig(name[:2], "mt" if "mt" in name else "watertight",
                                       "min" if "min" in name else "slot")
               for name in AB_CONFIGS}
    scene_cpu, cam, film = build_bench_scene(BENCH_TRIS, BENCH_RESOLUTION, device="cpu")
    scene = scene_cpu.to(dev)
    del scene_cpu
    batches = measure.bench_batches(scene, cam, film, dev)
    for name, cfg in configs.items():
        tris = scene.triangles.with_traverse(cfg)
        for bname in ("bounce", "merged"):
            res["traverse"][f"{name} {bname}"] = time_traversal(tris, batches[bname])
    del scene, batches
    torch.cuda.empty_cache()

    large_cpu, cam, film = build_bench_scene(LARGE_TRIS, BENCH_RESOLUTION, device="cpu")
    large = large_cpu.to(dev)
    del large_cpu
    merged = measure.bench_batches(large, cam, film, dev)["merged"]
    for name in LARGE_CONFIGS:
        res["traverse"][f"{name} large merged"] = time_traversal(
            large.triangles.with_traverse(configs[name]), merged)
    del large, merged
    torch.cuda.empty_cache()

    case = next(c for c in eg.cases() if c.name == COLS_CASE)
    table_t, idx = eg.make_inputs(case, dev)
    got = gk.row_gather_cols(table_t, idx)
    lib = torch.index_select(table_t, 1, idx)
    # The gather entry point's timer: launches queued behind a device-side
    # sleep, so that the host's launch cost stays out of a 10 us kernel.
    res["row_gather_cols"] = {
        "case": COLS_CASE,
        "equal_to_index_select": bool(torch.equal(got, lib)),
        "ms": eg.time_ms(lambda: gk.row_gather_cols(table_t, idx), dev),
        "index_select_ms": eg.time_ms(lambda: torch.index_select(table_t, 1, idx), dev),
    }
    res["chase"] = time_chase(dev)
    res["seconds"] = time.perf_counter() - t0
    return res


def summarize(paths) -> dict:
    """Per measurement: the mean of the runs labelled A* and of those
    labelled B*, and B / A; the hit and chase checksums must agree between
    A and B."""
    runs = [json.load(open(p)) for p in paths]
    groups = {"A": [r for r in runs if r["label"].startswith("A")],
              "B": [r for r in runs if r["label"].startswith("B")]}
    out = {"cards": sorted({r["card"] for r in runs}), "traverse": {}}
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
    cols = {g: [r["row_gather_cols"] for r in rs] for g, rs in groups.items()}
    out["row_gather_cols"] = {
        g: {"ms": float(np.mean([c["ms"] for c in cs])),
            "ms_runs": [c["ms"] for c in cs],
            "index_select_ms": float(np.mean([c["index_select_ms"] for c in cs])),
            "equal_to_index_select": all(c["equal_to_index_select"] for c in cs)}
        for g, cs in cols.items()
    }
    out["chase"] = {}
    for key in runs[0]["chase"]:
        line = {g: {"ms": float(np.mean([r["chase"][key]["ms"] for r in rs])),
                    "ms_runs": [r["chase"][key]["ms"] for r in rs]}
                for g, rs in groups.items()}
        line["B_over_A_ms"] = line["B"]["ms"] / line["A"]["ms"]
        line["same_output"] = len({r["chase"][key]["checksum"] for r in runs}) == 1
        out["chase"][key] = line
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", help="run label: A... (before) or B... (after)")
    ap.add_argument("--out", help="write the run's JSON here")
    ap.add_argument("--summarize", nargs="+", metavar="JSON", help="summarise runs instead")
    args = ap.parse_args(argv)
    if args.summarize:
        print(json.dumps(summarize(args.summarize), indent=1))
        return
    res = run(args.label or "B")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f)
    print(json.dumps(res))


if __name__ == "__main__":
    sys.exit(main())
