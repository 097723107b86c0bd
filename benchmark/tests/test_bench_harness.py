"""The harness: cells, configurations, traffic mixes and metric readers
found by name; the result line's keys; the import check; no card, no
result."""

import contextlib
import io
import json
import shutil
import subprocess
import sys

import pytest
import torch
from conftest import tiny_run

from benchmark import harness
from benchmark import scene as sc

BENCH = harness.load_bench()
CELLS = [w["name"] for w in BENCH["workloads"]]
KEYS = {"correct", "attempted", "failed", "metrics", "device", "compared"}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_parts_found_by_name(cell):
    c, config, traffic = harness.load_cell(BENCH, cell)
    assert config["name"] == c["config"]
    loop = harness.module("loops", traffic["kind"])
    assert all(callable(getattr(loop, f)) for f in ("loop", "check", "control"))
    builder = sc.builder(config)
    assert callable(builder.geometry) and callable(builder.build)
    for m in BENCH["per_layer"]:
        if harness.applies(m, c, BENCH):
            assert callable(harness.reader(m["name"]))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(cell, trace):
    run = tiny_run(cell, trace=trace)
    line = harness.execute(run)
    assert set(line) == KEYS
    assert list(line)[-1] == "compared"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    c = harness.find(BENCH["workloads"], cell, "workload")
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in BENCH[kind] if harness.applies(m, c, BENCH)}
    # On the CPU no device trace is taken and no device memory counted, so
    # those readers find nothing.
    device_only = {m["name"] for m in BENCH[kind] if m["source"] == "device_trace"}
    device_only.add("grad_peak_gb")
    assert want - device_only <= set(line["metrics"]) <= want
    for name, m in line["metrics"].items():
        assert m["value"] > 0 and m["unit"], name
    json.dumps(line)


def test_breakdown_comes_before_compared():
    run = tiny_run(CELLS[0])
    line = harness.result_line(run, True, {"x": {"value": 0.0, "limit": 1.0}}, {}, {},
                               {"device_ops": [], "idle_gaps": []})
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                          "compared"]


NEW_SCENE = """
from pathlib import Path

from benchmark import harness

_base = harness.module("scenes", "sphere_floor", Path(__file__).resolve().parents[2])
geometry = _base.geometry


def build(api, config, geom, device):
    # The bench scene seen from further off.
    config = dict(config, camera=dict(config["camera"], fov=55.0))
    return _base.build(api, config, geom, device)
"""

NEW_LOOP = """
from pathlib import Path

from benchmark import harness

_frames = harness.module("loops", "frames", Path(__file__).resolve().parents[2])
check, control = _frames.check, _frames.control


def loop(run):
    _frames.loop(run)
    run.data["frames_seen"] = run.data["frames"]
"""


def test_a_new_cell_and_metric_need_only_new_files(tmp_path):
    """A cell on a new configuration with a new scene kind, under a new
    traffic mix of a new loop kind, with a new per-layer metric: files
    and entries added to a copy of the benchmark, none edited."""
    shutil.copytree(harness.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    new = tmp_path / "benchmark"
    before = {p: p.read_bytes() for p in new.rglob("*") if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    config = json.loads((new / "configs" / "diffuse-720p.json").read_text())
    (new / "configs" / "wide-720p.json").write_text(json.dumps(
        dict(config, name="wide-720p", scene="sphere_wide")))
    (new / "scenes" / "sphere_wide.py").write_text(NEW_SCENE)
    (new / "loops" / "frames_seen.py").write_text(NEW_LOOP)
    (new / "traffic" / "short.json").write_text(json.dumps(
        {"kind": "frames_seen", "spp": 2, "wave_spp": 2, "pixel_block": 131072}))
    (new / "metrics" / "frames_done.py").write_text(
        "def read(run):\n    return run.data.get('frames_seen')\n")
    bench["configs"].append({"name": "wide-720p", "source": "https://pbrt.org/fileformat-v4",
                             "file": "benchmark/configs/wide-720p.json", "reduced": [],
                             "why": "a test configuration"})
    bench["workloads"].append({"name": "wide-720p.short", "config": "wide-720p",
                               "traffic": "short", "chips": 1, "why": "a test cell"})
    bench["end_to_end"][0]["workloads"].append("wide-720p.short")
    bench["per_layer"].append({"name": "frames_done", "unit": "frames", "better": "higher",
                               "source": "program_counter", "layer": "render driver",
                               "moves": "msamples_per_s", "workloads": ["wide-720p.short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    assert all(p.read_bytes() == b for p, b in before.items())
    run = tiny_run("wide-720p.short", trace=True, bench=harness.load_bench(tmp_path),
                   root=tmp_path)
    line = harness.execute(run)
    assert line["correct"] and line["metrics"]["frames_done"]["value"] >= 1


def test_import_check_compares_whole_top_level_names():
    mods = dict.fromkeys(["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
                          "shimmer_tpu", "shimmer_tpu.ops.bvh", "shimmer_tpu_torch",
                          "shimmer_tpu_torch.render", "jaxtyping", "numpy"])
    assert harness.forbidden_modules(mods) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "shimmer_tpu",
         "shimmer_tpu.ops.bvh"])


def test_a_run_loads_nothing_of_jax():
    run = tiny_run(CELLS[0])
    harness.execute(run)
    code = ("import sys; sys.path.insert(0, %r); from benchmark import harness, port, "
            "compare, scene, trace, yardstick, control; from benchmark.reference import grad; "
            "[harness.module(d, p.stem) for d in ('loops', 'scenes', 'metrics') "
            "for p in (harness.ROOT / 'benchmark' / d).glob('*.py')]; "
            "import shimmer_tpu_torch.render; print(harness.forbidden_modules())"
            % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip() == "[]"


def test_no_card_no_result(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = harness.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace",
                           "0"], 0.0)
    assert rc != 0 and out.getvalue() == "" and "CUDA" in err.getvalue()


def test_without_the_program_no_result(tmp_path):
    shutil.copytree(harness.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed",
                          "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
