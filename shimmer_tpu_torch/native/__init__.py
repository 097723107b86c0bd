"""Native (C++) host builder: the binned-SAH binary BVH of ``sah.cpp``.

The port's own copy of ``shimmer_tpu/native``.  ``sah.cpp`` is compiled
with g++ at first use into ``shimmer_tpu_torch/_build/`` (git-ignored) and
loaded with ctypes; no compiled object is committed.  The build flags are
the reference's, so both packages build the same hierarchy from the same
boxes.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "sah.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_SO = _BUILD_DIR / "_sah.so"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_LIB = None
_LIB_ERR = None


def _compile_and_load():
    global _LIB, _LIB_ERR
    with _LOCK:
        if _LIB is not None or _LIB_ERR is not None:
            return _LIB
        try:
            if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
                _BUILD_DIR.mkdir(parents=True, exist_ok=True)
                # Build to a private name and rename: concurrent test
                # workers may build at the same time.
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
                os.close(fd)
                try:
                    subprocess.run(
                        ["g++", *GXX_FLAGS, str(_SRC), "-o", tmp],
                        check=True, capture_output=True,
                    )
                    os.replace(tmp, _SO)
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
            lib = ctypes.CDLL(str(_SO))
            lib.build_sah_bvh.restype = ctypes.c_int64
            _LIB = lib
        except subprocess.CalledProcessError as e:
            _LIB_ERR = f"g++ failed ({e.returncode}): {e.stderr.decode(errors='replace')}"
        except OSError as e:
            _LIB_ERR = f"{type(e).__name__}: {e}"
        return _LIB


def sah_available() -> bool:
    return _compile_and_load() is not None


def sah_error() -> str | None:
    """Why the native builder is unavailable (the compiler's or loader's
    message), or None when it loaded."""
    _compile_and_load()
    return _LIB_ERR


def build_sah_hierarchy(lo, hi, leaf_size: int = 8, nbins: int = 16):
    """Binned-SAH binary hierarchy with the dict contract of
    ``ops/bvh.py::binary_hierarchy``.  Returns None when the native
    builder is unavailable (no g++)."""
    lib = _compile_and_load()
    if lib is None:
        return None
    lo = np.ascontiguousarray(lo, np.float32)
    hi = np.ascontiguousarray(hi, np.float32)
    n = lo.shape[0]
    max_nodes = max(1, 2 * n - 1)
    order = np.empty(n, np.int32)
    node_l = np.empty(max_nodes, np.int64)
    node_r = np.empty(max_nodes, np.int64)
    left = np.empty(max_nodes, np.int64)
    right = np.empty(max_nodes, np.int64)
    is_leaf = np.empty(max_nodes, np.uint8)
    out_lo = np.empty((max_nodes, 3), np.float32)
    out_hi = np.empty((max_nodes, 3), np.float32)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    n_nodes = lib.build_sah_bvh(
        ptr(lo, ctypes.c_float), ptr(hi, ctypes.c_float),
        ctypes.c_int64(n), ctypes.c_int(leaf_size), ctypes.c_int(nbins),
        ptr(order, ctypes.c_int32),
        ptr(node_l, ctypes.c_int64), ptr(node_r, ctypes.c_int64),
        ptr(left, ctypes.c_int64), ptr(right, ctypes.c_int64),
        ptr(is_leaf, ctypes.c_uint8),
        ptr(out_lo, ctypes.c_float), ptr(out_hi, ctypes.c_float),
    )
    if n_nodes <= 0:
        return None
    s = slice(0, n_nodes)
    return {
        "order": order,
        "node_l": node_l[s],
        "node_r": node_r[s],
        "left": left[s],
        "right": right[s],
        "is_leaf": is_leaf[s].astype(bool),
        "lo": out_lo[s],
        "hi": out_hi[s],
    }
