"""The benchmark's entry point: reads BENCHMARK.json, finds the cell's
parts by name, runs the cell, judges it against the plain reference and
prints one JSON line.  Each part is a file of its own:

- a configuration, ``configs/<name>.json``, whose ``scene`` names its
  scene builder ``scenes/<scene>.py`` (see ``scene.py``);
- a traffic mix, ``traffic/<name>.json``: parameters only, whose ``kind``
  names the loop that reads them, ``loops/<kind>.py``, with
  ``loop(run)`` (set-up, warm-up, the window), ``check(run)`` (the
  numbers that decide ``correct``, each beside its limit) and
  ``control(config, traffic, seed, variant, device)`` (``control.py``);
- a per-layer metric, ``metrics/<name>.py``, with
  ``read(run) -> float | None``.

A new cell, scene kind, loop kind or metric is new files and entries.

A run needs a CUDA card: without one (or with fewer than the cell asks
for) it exits non-zero and prints no result.  After the window it checks
that no module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "shimmer_tpu")


class Run:
    """One run of one cell: what the loop, the readers and the check share."""

    def __init__(self, bench: dict, cell: dict, config: dict, traffic: dict, seed: int,
                 seconds: float, trace: bool, t0: float, device="cuda"):
        self.bench, self.cell, self.config, self.traffic = bench, cell, config, traffic
        self.seed, self.seconds, self.trace, self.t0 = seed, seconds, trace, t0
        self.device = torch.device(device)
        self.e2e: dict[str, float] = {}      # end-to-end metric values by name
        self.data: dict = {}                 # counters and spans of the window
        self.profile: dict | None = None     # trace.summarize of the profiled sub-window
        self.attempted = 0
        self.failed = 0
        self.port = None                     # what the loop built of the program
        self.judge = None                    # the loop's answers, for its check
        self.geom = None
        self.root = ROOT                     # where the cell's parts are found
        self._ref = None

    def reference(self):
        """(scene, camera, film) of the frozen reference, built once."""
        if self._ref is None:
            from benchmark import scene as sc
            self._ref = sc.build(sc.side(sc.REFERENCE), self.config, self.geom, self.device,
                                 self.root)
        return self._ref

    def loop(self):
        """The module of the traffic's loop kind."""
        return module("loops", self.traffic["kind"], self.root)


def load_bench(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find(items: list, name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def load_cell(bench: dict, workload: str, root: Path = ROOT):
    """(cell, configuration, traffic) of a workload, found by name."""
    cell = find(bench["workloads"], workload, "workload")
    entry = find(bench["configs"], cell["config"], "configuration")
    with open(root / entry["file"]) as f:
        config = json.load(f)
    with open(root / "benchmark" / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    return cell, config, traffic


def applies(metric: dict, cell: dict, bench: dict) -> bool:
    """Whether ``metric`` is reported in ``cell``."""
    if "workloads" in metric:
        return cell["name"] in metric["workloads"]
    if "moves" in metric:
        moved = find(bench["end_to_end"], metric["moves"], "metric")
        return applies(moved, cell, bench)
    return True


_MODULES: dict = {}


def module(folder: str, name: str, root: Path = ROOT):
    """``benchmark/<folder>/<name>.py``, loaded once per checkout."""
    path = root / "benchmark" / folder / f"{name}.py"
    if path not in _MODULES:
        if not path.is_file():
            raise SystemExit(f"no file {path.relative_to(root)} for {folder[:-1]} {name!r}")
        spec = importlib.util.spec_from_file_location(f"benchmark_{folder}_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


def reader(name: str, root: Path = ROOT):
    """The ``read`` function of ``benchmark/metrics/<name>.py``."""
    return module("metrics", name, root).read


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``shimmer_tpu_torch`` is not ``shimmer_tpu``)."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in list(modules) if m.split(".", 1)[0] in FORBIDDEN)


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0].strip() if out else None


def result_line(run: Run, correct: bool, compared: dict, metrics: dict, device: dict,
                breakdown: dict | None) -> dict:
    out = {"correct": bool(correct), "attempted": int(run.attempted), "failed": int(run.failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = compared
    return out


def per_layer(run: Run) -> dict:
    out = {}
    for m in run.bench["per_layer"]:
        if not applies(m, run.cell, run.bench):
            continue
        value = reader(m["name"], run.root)(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def end_to_end(run: Run) -> dict:
    out = {}
    for m in run.bench["end_to_end"]:
        if applies(m, run.cell, run.bench):
            if m["name"] not in run.e2e:
                raise RuntimeError(f"the {run.traffic['kind']} loop gave no {m['name']}")
            out[m["name"]] = {"value": float(run.e2e[m["name"]]), "unit": m["unit"]}
    return out


def execute(run: Run) -> dict:
    """Everything after the argument parsing: the loop, the readers, the
    check.  Returns the result line (a dict)."""
    loop = run.loop()
    loop.loop(run)
    dev = run.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": int(run.cell["chips"]),
              "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(dev),
                                           run.data.get("setup_peak_bytes", 0)))
              if dev.type == "cuda" else 0}
    breakdown = None
    if run.trace:
        metrics = per_layer(run)
        if run.profile is not None:
            device["busy_s"] = run.profile["busy_s"]
            device["window_s"] = run.profile["window_s"]
            breakdown = {"device_ops": run.profile["device_ops"],
                         "idle_gaps": run.profile["idle_gaps"]}
        if dev.type == "cuda":
            device["power_limit"] = power_limit()
    else:
        metrics = end_to_end(run)
    run.port = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    compared = loop.check(run)
    correct = run.failed == 0 and all(c["value"] <= c["limit"] for c in compared.values())
    return result_line(run, correct, compared, metrics, device, breakdown)


def main(argv, t0: float) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = load_bench()
    cell, config, traffic = load_cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = Run(bench, cell, config, traffic, args.seed, args.seconds, bool(args.trace), t0)
    line = execute(run)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or of the JAX package were loaded: {found}", file=sys.stderr)
        return 4
    for name, c in line["compared"].items():
        print(f"compared {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line))
    return 0
