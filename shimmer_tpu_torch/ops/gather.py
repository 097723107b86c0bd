"""Row gathers from a (R, W) table by int32 index: the hand-written CUDA
kernels, their wrappers, and their plain torch versions.

Replaces the Pallas kernels of the reference's gather experiments
(kernel-table rows 6-9 in PERF.md; ``csrc/gather.cu`` names each
function it replaces):

* :func:`row_gather` -- ``out[i] = T[idx[i]]``;
* :func:`row_gather_cols` -- the same from the transposed (W, R) table:
  ``out[:, i] = Tt[:, idx[i]]``;
* :func:`row_gather_sum` -- ``sum_i T[idx[i]]``;
* :func:`row_chase` -- per lane, ``steps`` dependent reads:
  ``row = T[idx]; acc += row[1] + ... + row[8]; idx = int(row[0])``, over
  float32 or bf16 rows.

An index outside [0, R) reads a row of zeros in every function (the
reference's one-hot product does so with an index that bf16 rounding
pushed to R), so a chase goes on from index 0 after one.

Each wrapper dispatches on the tensors' device: CUDA tensors launch the
kernel or raise; CPU tensors run the ``*_plain`` version.  Nothing falls
back from CUDA to the plain version.  Each wrapper counts its kernel
launches in ``.launches``, by kernel name.  The kernel library
``gather`` is built at first use by the port's shared nvcc build
(``ops/cuda_build.py``).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from shimmer_tpu_torch.ops import cuda_build

# Columns a chase step reads (csrc/gather_body.cuh kChaseCols).
CHASE_COLS = 9
# Widest row the gather-sum kernel takes (kSumMaxWidth).
SUM_MAX_WIDTH = 128
_INT_MAX = 2**31 - 1

_lock = threading.Lock()
_lib = None


def _library():
    """The ``gather`` library with its C signatures, built and loaded at
    first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = cuda_build.load("gather")
            p, ci = ctypes.c_void_p, ctypes.c_int
            lib.shimmer_row_gather.argtypes = [p, ci, ci, p, ci, p, p]
            lib.shimmer_row_gather_cols.argtypes = [p, ci, ci, p, ci, p, p]
            lib.shimmer_row_gather_sum.argtypes = [p, ci, ci, p, ci, p, p]
            lib.shimmer_row_chase.argtypes = [ci, p, ci, ci, p, ci, ci, p, p]
            for fn in (lib.shimmer_row_gather, lib.shimmer_row_gather_cols,
                       lib.shimmer_row_gather_sum, lib.shimmer_row_chase,
                       lib.shimmer_gather_sum_max_width):
                fn.restype = ci
            lib.shimmer_gather_sum_max_width.argtypes = []
            if lib.shimmer_gather_sum_max_width() != SUM_MAX_WIDTH:
                raise cuda_build.KernelBuildError("gather-sum width bound disagrees with the wrapper")
            _lib = lib
        return _lib


def _check_args(table, idx, dtypes):
    """Validate a call's table and indices; returns the device type."""
    if table.dim() != 2:
        raise ValueError(f"table must be 2-D, got shape {tuple(table.shape)}")
    if table.dtype not in dtypes:
        raise TypeError(f"table has dtype {table.dtype}, expected one of {dtypes}")
    if idx.dim() != 1:
        raise ValueError(f"idx must be 1-D, got shape {tuple(idx.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx has dtype {idx.dtype}, expected torch.int32")
    if idx.device != table.device:
        raise ValueError(f"idx is on {idx.device}, table on {table.device}")
    if not table.is_contiguous() or not idx.is_contiguous():
        raise ValueError("table and idx must be contiguous")
    if min(table.shape) < 1:
        raise ValueError(f"empty table of shape {tuple(table.shape)}")
    if max(*table.shape, idx.shape[0]) > _INT_MAX:
        raise ValueError("sizes must fit int32")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no gather for device {table.device}")
    if table.device.type == "cuda" and table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned on the card")
    return table.device.type


def row_gather(table, idx):
    """``table[idx]`` of a (R, W) float32 table, W a multiple of 4 -> (N,
    W).  Out-of-range indices give zero rows."""
    dev = _check_args(table, idx, (torch.float32,))
    n_rows, width = table.shape
    if width % 4:
        raise ValueError(f"row width {width} is not a multiple of 4")
    if dev == "cpu":
        return row_gather_plain(table, idx)
    n = idx.shape[0]
    out = torch.empty(n, width, dtype=torch.float32, device=table.device)
    cuda_build.raise_on_error(_library().shimmer_row_gather(
        table.data_ptr(), n_rows, width, idx.data_ptr(), n, out.data_ptr(),
        cuda_build.stream_of(table)), "row_gather")
    row_gather.launches["row_gather"] += 1
    return out


row_gather.launches = {"row_gather": 0}


def row_gather_cols(table_t, idx):
    """``table_t[:, idx]`` of a transposed (W, R) float32 table -> (W, N).
    Out-of-range indices give zero columns."""
    dev = _check_args(table_t, idx, (torch.float32,))
    if dev == "cpu":
        return row_gather_cols_plain(table_t, idx)
    width, n_rows = table_t.shape
    n = idx.shape[0]
    out = torch.empty(width, n, dtype=torch.float32, device=table_t.device)
    cuda_build.raise_on_error(_library().shimmer_row_gather_cols(
        table_t.data_ptr(), n_rows, width, idx.data_ptr(), n, out.data_ptr(),
        cuda_build.stream_of(table_t)), "row_gather_cols")
    row_gather_cols.launches["row_gather_cols"] += 1
    return out


row_gather_cols.launches = {"row_gather_cols": 0}


def row_gather_sum(table, idx):
    """``table[idx].sum(0)`` of a (R, W) float32 table, W a multiple of 4
    and at most 128 -> (W,).  The kernel's sum is in another order than
    the plain version's, and its last bits vary from run to run."""
    dev = _check_args(table, idx, (torch.float32,))
    n_rows, width = table.shape
    if width % 4 or width > SUM_MAX_WIDTH:
        raise ValueError(f"row width {width}: expected a multiple of 4, at most {SUM_MAX_WIDTH}")
    if dev == "cpu":
        return row_gather_sum_plain(table, idx)
    out = torch.empty(width, dtype=torch.float32, device=table.device)
    cuda_build.raise_on_error(_library().shimmer_row_gather_sum(
        table.data_ptr(), n_rows, width, idx.data_ptr(), idx.shape[0], out.data_ptr(),
        cuda_build.stream_of(table)), "row_gather_sum")
    row_gather_sum.launches["row_gather_sum"] += 1
    return out


row_gather_sum.launches = {"row_gather_sum": 0}


def row_chase(table, idx, steps: int):
    """Per lane, ``steps`` dependent row reads from ``idx``: ``acc +=
    row[1] + ... + row[8]`` (left to right), ``idx = int(row[0])``.
    table: (R, W) float32 or bfloat16, W a multiple of 8 (>= 16).
    Returns the (N,) float32 accumulators."""
    dev = _check_args(table, idx, (torch.float32, torch.bfloat16))
    n_rows, width = table.shape
    if width < CHASE_COLS or width % 8:
        raise ValueError(f"row width {width}: expected a multiple of 8, at least {CHASE_COLS}")
    steps = int(steps)
    if not 0 <= steps <= _INT_MAX:
        raise ValueError(f"steps={steps} out of range")
    if dev == "cpu":
        return row_chase_plain(table, idx, steps)
    bf16 = table.dtype == torch.bfloat16
    name = "row_chase_bf16" if bf16 else "row_chase_f32"
    out = torch.empty(idx.shape[0], dtype=torch.float32, device=table.device)
    cuda_build.raise_on_error(_library().shimmer_row_chase(
        int(bf16), table.data_ptr(), n_rows, width, idx.data_ptr(), idx.shape[0], steps,
        out.data_ptr(), cuda_build.stream_of(table)), name)
    row_chase.launches[name] += 1
    return out


row_chase.launches = {"row_chase_f32": 0, "row_chase_bf16": 0}

WRAPPERS = (row_gather, row_gather_cols, row_gather_sum, row_chase)


def launch_counts() -> dict:
    """Kernel launches by kernel name, over all the wrappers."""
    return {k: v for w in WRAPPERS for k, v in w.launches.items()}


def reset_launches():
    for w in WRAPPERS:
        w.launches = dict.fromkeys(w.launches, 0)


def _in_range(idx, n_rows):
    ok = (idx >= 0) & (idx < n_rows)
    return ok, torch.where(ok, idx, 0).long()


def row_gather_plain(table, idx):
    """Plain torch version of :func:`row_gather`."""
    ok, safe = _in_range(idx, table.shape[0])
    return torch.where(ok[:, None], table[safe], 0.0)


def row_gather_cols_plain(table_t, idx):
    """Plain torch version of :func:`row_gather_cols`."""
    ok, safe = _in_range(idx, table_t.shape[1])
    return torch.where(ok[None, :], table_t[:, safe], 0.0)


def row_gather_sum_plain(table, idx):
    """Plain torch version of :func:`row_gather_sum` (torch's own
    reduction order)."""
    return row_gather_plain(table, idx).sum(0)


def row_chase_plain(table, idx, steps: int, stats: dict | None = None):
    """Plain torch version of :func:`row_chase`, in the kernel's order of
    additions.  ``stats``, a dict or None, receives ``rows_read`` ((R,)
    bool, the rows the chase read) and ``oob_lanes`` ((N,) bool, the lanes
    that met an out-of-range index)."""
    n_rows = table.shape[0]
    acc = torch.zeros(idx.shape[0], dtype=torch.float32, device=table.device)
    cur = idx
    rows_read = torch.zeros(n_rows, dtype=torch.bool, device=table.device)
    oob = torch.zeros(idx.shape[0], dtype=torch.bool, device=table.device)
    for _ in range(int(steps)):
        ok, safe = _in_range(cur, n_rows)
        v = torch.where(ok[:, None], table[safe, :CHASE_COLS].float(), 0.0)
        s = v[:, 1]
        for j in range(2, CHASE_COLS):
            s = s + v[:, j]
        acc = acc + s
        if stats is not None:
            rows_read[safe[ok]] = True
            oob |= ~ok
        x0 = v[:, 0]
        cur = torch.where((x0 > -1.0) & (x0 < n_rows), x0.to(torch.int32), -1)
    if stats is not None:
        stats["rows_read"] = rows_read
        stats["oob_lanes"] = oob
    return acc
