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
    ],
    ids=["shimmer_tpu_torch", "own_host_modules", "chip_smoke"],
)
def test_imports_without_jax(names):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT.format(names=repr(names))],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 1
