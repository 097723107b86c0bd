"""The PyTorch port imports neither JAX nor the JAX package: every module of
shimmer_tpu_torch, the port's own copies of the host-only builders, and
chip_smoke.py import in a fresh interpreter with ``jax`` and
``shimmer_tpu`` blocked."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

_BLOCKED_IMPORT = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["shimmer_tpu"] = None
names = {names}
if names == "package":
    import shimmer_tpu_torch
    names = ["shimmer_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(shimmer_tpu_torch.__path__, "shimmer_tpu_torch.")
    ]
for name in names:
    importlib.import_module(name)
if "shimmer_tpu_torch.experiments.gather" in names:
    # The entry point runs, not only imports: every case at a small size.
    import dataclasses
    from shimmer_tpu_torch.experiments import gather
    for case in gather.cases():
        case = dataclasses.replace(case, n_rows=case.n_rows // 256, n=max(1, case.n // 256),
                                   steps=min(case.steps, 32))
        assert gather.run_case(case, *gather.make_inputs(case, "cpu"))["ok"]
if "shimmer_tpu_torch.experiments.packet_step" in names:
    # The entry point runs, not only imports: every case at a small size
    # (row 15 on a small scene of the port's own builder).
    import dataclasses
    from shimmer_tpu_torch import bench_scene
    from shimmer_tpu_torch.experiments import packet_step
    t = bench_scene.build_bench_scene(320, (8, 8), device="cpu")[0].triangles
    for case in packet_step.cases():
        case = dataclasses.replace(case, n_rows=256, steps=tuple(8 * (i + 1) for i in range(len(case.steps))),
                                   programs=min(case.programs, 2))
        x = packet_step.make_inputs(case, "cpu", (t.rows8, t.meta, t.stack_depth))
        assert packet_step.run_case(case, x)["ok"]
if "shimmer_tpu_torch.ops.bvh8" in names:
    # The builders run, not only import: native SAH build and 8-wide pack.
    import numpy as np
    from shimmer_tpu_torch.ops.bvh8 import bvh8_validate, pack_bvh8
    tri = np.random.default_rng(0).random((64, 3, 3)).astype(np.float32)
    arrs = pack_bvh8(tri.min(1), tri.max(1), tri)
    assert bvh8_validate(arrs, tri.min(1), tri.max(1))
blocked = ("jax", "jaxlib", "shimmer_tpu")
leaked = sorted(m for m in sys.modules if m.split(".")[0] in blocked and sys.modules[m] is not None)
assert not leaked, leaked
print(len(names))
"""


@pytest.mark.parametrize(
    "names",
    [
        "package",
        ["shimmer_tpu_torch.ops.bvh", "shimmer_tpu_torch.ops.bvh8", "shimmer_tpu_torch.native"],
        ["chip_smoke"],
        ["shimmer_tpu_torch.ops.cuda_build", "shimmer_tpu_torch.ops.gather",
         "shimmer_tpu_torch.experiments.gather"],
        ["shimmer_tpu_torch.ops.cuda_build", "shimmer_tpu_torch.ops.packet_step",
         "shimmer_tpu_torch.experiments.packet_step"],
        ["shimmer_tpu_torch.ops.traverse", "shimmer_tpu_torch.measure",
         "shimmer_tpu_torch.experiments.kernel_ab"],
    ],
    ids=["shimmer_tpu_torch", "own_host_modules", "chip_smoke", "gather_modules",
         "packet_step_modules", "kernel_ab_modules"],
)
def test_imports_without_jax(names):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT.format(names=repr(names))],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 1
