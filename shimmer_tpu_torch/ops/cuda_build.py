"""The nvcc build of the port's CUDA kernel libraries, shared by every
kernel wrapper (``ops/traverse.py``, ``ops/gather.py``,
``ops/packet_step.py``, ``ops/sampler.py``).

Each library is one ``.cu`` source in ``csrc/`` (plus the headers it
includes) with a plain C interface, compiled by nvcc
(``-gencode arch=compute_90a,code=sm_90a -O3 -fmad=false``) into the
git-ignored ``shimmer_tpu_torch/_build/`` at first use, rebuilt when one
of its sources is newer than it, and loaded with ctypes.  :func:`build`
starts one nvcc process per library, all at once, and waits for all of
them, so the whole set costs the time of the slowest source.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# Library name -> (its .cu source, the headers it includes).
LIBRARIES = {
    "traverse": ("traverse.cu", ("traverse_body.cuh", "traverse_v2_body.cuh")),
    "gather": ("gather.cu", ("gather_body.cuh",)),
    "packet_step": ("packet_step.cu", ("packet_step_body.cuh", "traverse_body.cuh")),
    "sampler": ("sampler.cu", ("sampler_body.cuh",)),
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-fmad=false", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    pass


def library_path(name: str) -> Path:
    return BUILD_DIR / f"libshimmer_{name}.so"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError("nvcc not found (set CUDA_HOME)")
    return found


def _stale(name: str) -> bool:
    lib = library_path(name)
    source, headers = LIBRARIES[name]
    return not lib.exists() or lib.stat().st_mtime < max(
        (CSRC / f).stat().st_mtime for f in (source, *headers))


def build(names=None, force: bool = False) -> dict:
    """Compile the named libraries (default: all) that are missing or
    older than a source (or all of them with ``force``), one nvcc process
    each, started together.  Returns {name: {"built", "seconds", "log"}}
    per library, the log holding nvcc's ``-Xptxas -v`` report; raises
    :class:`KernelBuildError` if any nvcc run fails."""
    names = tuple(LIBRARIES) if names is None else tuple(names)
    out = {n: {"built": False, "seconds": 0.0, "log": ""} for n in names}
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    try:
        for name in todo:
            # Build to a private name and rename, so a concurrent loader
            # never sees a partial library.
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(CSRC / LIBRARIES[name][0])]
            procs[name] = (cmd, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (cmd, tmp, proc) in procs.items():
            log = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
                continue
            os.replace(tmp, library_path(name))
            out[name] = {"built": True, "seconds": time.perf_counter() - t0, "log": log}
    finally:
        for _, tmp, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    if failed:
        raise KernelBuildError("\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The named library, built if stale and loaded once per process."""
    with _lock:
        if name not in _loaded:
            build((name,))
            _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return _loaded[name]


def load_host(name: str) -> ctypes.CDLL:
    """``csrc/{name}_host.cpp``, the host build of a library's kernel bodies
    (the kernels' own order of operations on the CPU), compiled with g++
    without FMA contraction (as nvcc builds the kernels, -fmad=false) into
    ``_build/`` and loaded.  tests/test_torch_gather_card.py holds the
    card's results to it; no wrapper loads it."""
    source = CSRC / f"{name}_host.cpp"
    lib = BUILD_DIR / f"libshimmer_{name}_host.so"
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(["g++", "-O2", "-std=c++17", "-ffp-contract=off", "-shared",
                                   "-fPIC", "-I", str(CSRC), str(source), "-o", tmp],
                                  capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise KernelBuildError(f"g++ failed ({proc.returncode}) on {source}:\n{proc.stderr}")
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return ctypes.CDLL(str(lib))


# --- shared by the wrappers of every library ---


def check_tensor(name: str, x, dtype, shape, device):
    """Raise unless ``x`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` (what a kernel's C entry point takes)."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def raise_on_error(err: int, name: str):
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def stream_of(t) -> int:
    """The current CUDA stream of ``t``'s device, as the entry points take it."""
    return torch.cuda.current_stream(t.device).cuda_stream
