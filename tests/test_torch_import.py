"""The PyTorch port imports no JAX: every module of shimmer_tpu_torch, the
reference's shared host-only modules it uses, and chip_smoke.py import in a
fresh interpreter with ``jax`` blocked."""

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
names = {names}
if names == "package":
    import shimmer_tpu_torch
    names = ["shimmer_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(shimmer_tpu_torch.__path__, "shimmer_tpu_torch.")
    ]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib") and sys.modules[m] is not None)
assert not leaked, leaked
print(len(names))
"""


@pytest.mark.parametrize(
    "names",
    [
        "package",
        ["shimmer_tpu.ops.bvh", "shimmer_tpu.ops.bvh8", "shimmer_tpu.native"],
        ["chip_smoke"],
    ],
    ids=["shimmer_tpu_torch", "shared_host_modules", "chip_smoke"],
)
def test_imports_without_jax(names):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT.format(names=repr(names))],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 1
