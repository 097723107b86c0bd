"""Row gathers from a (R, W) table by int32 index: the hand-written CUDA
kernels, their wrappers, and their plain torch versions.

Replaces the Pallas kernels of the reference's gather experiments
(kernel-table rows 6-9 in PERF.md; ``csrc/gather.cu`` names each
function it replaces):

* :func:`row_gather` -- ``out[i] = T[idx[i]]``;
* :func:`row_gather_cols` -- the same from the transposed (W, R) table:
  ``out[:, i] = Tt[:, idx[i]]``;
* :func:`row_gather_sum` -- ``sum_i T[idx[i]]``, on the card counted
  (the indices counted per row, then each distinct row read once and
  added times its count) where :func:`gather_sum_counted` says so, else
  direct; both add in a fixed order, so the sum is the same bits on
  every run;
* :func:`row_gather_col_sum` -- one column of it, ``repeats * sum_i
  T[idx[i], col]`` (6D);
* :func:`row_chase` -- per lane, ``steps`` dependent reads:
  ``row = T[idx]; acc += row[1] + ... + row[8]; idx = int(row[0])``, over
  float32 or bf16 rows.  On the card a chase that :func:`chase_staged`
  names (a few lanes with long chains, or many lanes with enough steps)
  runs staged: a
  pass writes each row's (next index, row sum) (:func:`chase_pairs_plain`
  computes the same), and a grid of blocks, each with the pairs staged in
  its shared memory, walks the lanes (:func:`chase_walk`, which also
  takes the pairs alone);
* :func:`row_scatter_add` -- ``out[r] = sum_{i: idx[i] == r} grad[i]``
  for a table of at most 32 rows of 2-32 floats, added from 0 in lane
  order, so equal bit for bit to torch's ``index_put_(accumulate=True)``
  on the card; :func:`gather_rows` is ``table[idx]`` with it for a
  backward where :func:`backward_reason` allows.

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
from torch.autograd.function import once_differentiable

from shimmer_tpu_torch.ops import cuda_build
from shimmer_tpu_torch.utils import stats

# Columns a chase step reads (csrc/gather_body.cuh kChaseCols).
CHASE_COLS = 9
# Widest row the gather-sum kernel takes (kSumMaxWidth), and most blocks
# (partials) of its grid (kSumMaxBlocks).
SUM_MAX_WIDTH = 128
SUM_MAX_BLOCKS = 128
# The counted gather-sum (csrc/gather_body.cuh gather_sum_counted): at
# most SUM_COUNTED_MAX_N indices (a count converts to float exactly below
# 2^24), at least SUM_COUNTED_INDICES_PER_ROW times R, over at least
# SUM_COUNTED_MIN_ROWS rows of at least SUM_COUNTED_MIN_WIDTH floats.
SUM_COUNTED_MAX_N = 2**24 - 1
SUM_COUNTED_INDICES_PER_ROW = 4
SUM_COUNTED_MIN_ROWS = 16384
SUM_COUNTED_MIN_WIDTH = 128
# The one-column sum: most blocks (partials) of its grid, and the largest
# repeat count (it converts to float exactly).
COL_SUM_MAX_BLOCKS = 128
COL_SUM_MAX_REPEATS = 2**24
# The staged chase (csrc/gather_body.cuh chase_staged): at most
# STAGE_MAX_ROWS rows (R + 1 pairs of 8 bytes in 227 KB of shared memory);
# a few lanes (at most STAGE_MAX_LANES) with at least STAGE_MIN_STEPS steps
# and R / 64; more lanes with at least WIDE_MIN_STEPS steps, or at least
# MANY_LANES lanes with at least MANY_LANES_MIN_STEPS steps.
STAGE_MAX_LANES = 32
STAGE_MAX_ROWS = 227 * 1024 // 8 - 1
STAGE_MIN_STEPS = 256
WIDE_MIN_STEPS = 32
MANY_LANES = 131072
MANY_LANES_MIN_STEPS = 8
# The scatter-add (csrc/gather.cu kScatter*): tables of at most
# SCATTER_MAX_ROWS rows of SCATTER_MIN_WIDTH to SCATTER_MAX_WIDTH floats
# (the widths torch's backward of an index adds in lane order on the card,
# its small-stride kernel).
SCATTER_MAX_ROWS = 32
SCATTER_MIN_WIDTH = 2
SCATTER_MAX_WIDTH = 32
_INT_MAX = 2**31 - 1

# The bounds the library reports, in the order _library reads them.
LIBRARY_BOUNDS = (SUM_MAX_WIDTH, STAGE_MAX_LANES, STAGE_MAX_ROWS, STAGE_MIN_STEPS,
                  WIDE_MIN_STEPS, MANY_LANES, MANY_LANES_MIN_STEPS, SUM_MAX_BLOCKS,
                  SUM_COUNTED_MAX_N, SUM_COUNTED_INDICES_PER_ROW, SUM_COUNTED_MIN_ROWS,
                  SUM_COUNTED_MIN_WIDTH,
                  COL_SUM_MAX_BLOCKS, COL_SUM_MAX_REPEATS,
                  SCATTER_MAX_ROWS, SCATTER_MIN_WIDTH, SCATTER_MAX_WIDTH)

_lock = threading.Lock()
_lib = None
# The gather-sums' int32 scratch, one per (card, stream), 0 between
# launches (each launch leaves it so; launches on one stream run one at a
# time): [0] the ticket of the last block, [1 ..] the counted form's counts.
_scratch: dict = {}


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
            lib.shimmer_row_gather_sum.argtypes = [p, ci, ci, p, ci, p, p, p, p]
            lib.shimmer_row_gather_col_sum.argtypes = [p, ci, ci, p, ci, ci, ci, p, p, p, p]
            lib.shimmer_row_chase.argtypes = [ci, p, ci, ci, p, ci, ci, p, p, p]
            lib.shimmer_chase_walk.argtypes = [p, ci, p, ci, ci, p, p]
            lib.shimmer_row_scatter_add.argtypes = [p, p, ci, ci, ci, p, p]
            bounds = (lib.shimmer_gather_sum_max_width, lib.shimmer_chase_stage_max_lanes,
                      lib.shimmer_chase_stage_max_rows, lib.shimmer_chase_stage_min_steps,
                      lib.shimmer_chase_wide_min_steps, lib.shimmer_chase_many_lanes,
                      lib.shimmer_chase_many_lanes_min_steps, lib.shimmer_gather_sum_max_blocks,
                      lib.shimmer_gather_sum_counted_max_n,
                      lib.shimmer_gather_sum_counted_indices_per_row,
                      lib.shimmer_gather_sum_counted_min_rows,
                      lib.shimmer_gather_sum_counted_min_width,
                      lib.shimmer_col_sum_max_blocks, lib.shimmer_col_sum_max_repeats,
                      lib.shimmer_scatter_max_rows, lib.shimmer_scatter_min_width,
                      lib.shimmer_scatter_max_width)
            for fn in (lib.shimmer_row_gather, lib.shimmer_row_gather_cols,
                       lib.shimmer_row_gather_sum, lib.shimmer_row_gather_col_sum,
                       lib.shimmer_row_chase, lib.shimmer_chase_walk,
                       lib.shimmer_row_scatter_add, *bounds):
                fn.restype = ci
            for fn in bounds:
                fn.argtypes = []
            if tuple(fn() for fn in bounds) != LIBRARY_BOUNDS:
                raise cuda_build.KernelBuildError("gather bounds disagree with the wrapper")
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


def _zero_scratch(t, size: int):
    """The gather-sums' scratch of ``t``'s card and current stream, at least
    ``size`` int32, made (zero) or grown at first need."""
    key = (t.device.index, cuda_build.stream_of(t))
    if key not in _scratch or _scratch[key].shape[0] < size:
        _scratch[key] = torch.zeros(size, dtype=torch.int32, device=t.device)
    return _scratch[key]


def gather_sum_counted(n_rows: int, n: int, width: int) -> bool:
    """Whether the card sums ``n`` indices over ``n_rows`` rows of
    ``width`` floats counted: csrc/gather_body.cuh gather_sum_counted,
    whose bounds the library is checked against when it loads (the kernel
    takes the counts' scratch only then)."""
    return (n <= SUM_COUNTED_MAX_N and n_rows >= SUM_COUNTED_MIN_ROWS
            and width >= SUM_COUNTED_MIN_WIDTH and n >= SUM_COUNTED_INDICES_PER_ROW * n_rows)


def row_gather_sum(table, idx):
    """``table[idx].sum(0)`` of a (R, W) float32 table, W a multiple of 4
    and at most 128 -> (W,).  Out-of-range indices add nothing.  On the
    card the sum is counted or direct (:func:`gather_sum_counted`), each in
    a fixed order: the same bits on every run, another order than the plain
    version's.  ``launches`` counts the calls by the form that ran."""
    dev = _check_args(table, idx, (torch.float32,))
    n_rows, width = table.shape
    if width % 4 or width > SUM_MAX_WIDTH:
        raise ValueError(f"row width {width}: expected a multiple of 4, at most {SUM_MAX_WIDTH}")
    if dev == "cpu":
        return row_gather_sum_plain(table, idx)
    n = idx.shape[0]
    counted = gather_sum_counted(n_rows, n, width)
    scratch = _zero_scratch(table, 1 + (n_rows if counted else 0))
    partials = torch.empty(SUM_MAX_BLOCKS * width, dtype=torch.float32, device=table.device)
    out = torch.empty(width, dtype=torch.float32, device=table.device)
    cuda_build.raise_on_error(_library().shimmer_row_gather_sum(
        table.data_ptr(), n_rows, width, idx.data_ptr(), n, partials.data_ptr(),
        scratch.data_ptr(), out.data_ptr(), cuda_build.stream_of(table)), "row_gather_sum")
    row_gather_sum.launches["row_gather_sum_counted" if counted else "row_gather_sum"] += 1
    return out


row_gather_sum.launches = {"row_gather_sum": 0, "row_gather_sum_counted": 0}


def row_gather_col_sum(table, idx, col: int, repeats: int = 1):
    """``repeats * table[idx, col].sum()`` of a (R, W) float32 table -> a
    0-d float32 tensor; out-of-range indices add 0.  On the card one
    launch, in a fixed order (the same bits on every run)."""
    dev = _check_args(table, idx, (torch.float32,))
    n_rows, width = table.shape
    col, repeats = int(col), int(repeats)
    if not 0 <= col < width:
        raise ValueError(f"col={col} outside a row of width {width}")
    if not 0 <= repeats <= COL_SUM_MAX_REPEATS:
        raise ValueError(f"repeats={repeats}: expected 0-{COL_SUM_MAX_REPEATS}")
    if dev == "cpu":
        return row_gather_col_sum_plain(table, idx, col, repeats)
    partials = torch.empty(COL_SUM_MAX_BLOCKS, dtype=torch.float32, device=table.device)
    out = torch.empty((), dtype=torch.float32, device=table.device)
    cuda_build.raise_on_error(_library().shimmer_row_gather_col_sum(
        table.data_ptr(), n_rows, width, idx.data_ptr(), idx.shape[0], col, repeats,
        partials.data_ptr(), _zero_scratch(table, 1).data_ptr(), out.data_ptr(),
        cuda_build.stream_of(table)), "row_gather_col_sum")
    row_gather_col_sum.launches["row_gather_col_sum"] += 1
    return out


row_gather_col_sum.launches = {"row_gather_col_sum": 0}


def row_chase(table, idx, steps: int):
    """Per lane, ``steps`` dependent row reads from ``idx``: ``acc +=
    row[1] + ... + row[8]`` (left to right), ``idx = int(row[0])``.
    table: (R, W) float32 or bfloat16, W a multiple of 8 (>= 16).
    Returns the (N,) float32 accumulators.  ``launches`` counts each call
    by its table's type, and the calls that ran staged (two launches, the
    pass and the walk) also under ``row_chase_staged``."""
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
    n = idx.shape[0]
    # The staged form's scratch: the R + 1 (next index, row sum) pairs.
    staged = chase_staged(n_rows, n, steps)
    work = torch.empty(n_rows + 1, 2, dtype=torch.int32, device=table.device) if staged else None
    out = torch.empty(n, dtype=torch.float32, device=table.device)
    cuda_build.raise_on_error(_library().shimmer_row_chase(
        int(bf16), table.data_ptr(), n_rows, width, idx.data_ptr(), n, steps,
        None if work is None else work.data_ptr(), out.data_ptr(),
        cuda_build.stream_of(table)), name)
    row_chase.launches[name] += 1
    if staged:
        row_chase.launches["row_chase_staged"] += 1
    return out


row_chase.launches = {"row_chase_f32": 0, "row_chase_bf16": 0, "row_chase_staged": 0}


def chase_staged(n_rows: int, n: int, steps: int) -> bool:
    """Whether the card runs a chase of ``n`` lanes and ``steps`` steps over
    ``n_rows`` rows staged: csrc/gather_body.cuh chase_staged, whose bounds
    the library is checked against when it loads (and the kernel refuses a
    staged chase without its scratch)."""
    if n < 1 or n_rows > STAGE_MAX_ROWS:
        return False
    if n <= STAGE_MAX_LANES:
        return steps >= STAGE_MIN_STEPS and steps >= n_rows // 64
    return steps >= WIDE_MIN_STEPS or (n >= MANY_LANES and steps >= MANY_LANES_MIN_STEPS)


def chase_walk(pairs, idx, steps: int):
    """The staged chase's walk alone: ``steps`` steps per lane over
    ``pairs`` ((R + 1, 2) int32, :func:`chase_pairs_plain` of the table:
    each row's next index and the bits of its float32 row sum), at least
    one lane and at most ``STAGE_MAX_ROWS`` rows on the card.  Equal to
    ``row_chase(table, idx, steps)``."""
    if pairs.dim() != 2 or pairs.shape[1] != 2 or pairs.dtype != torch.int32:
        raise ValueError(f"pairs must be (R + 1, 2) int32, got {tuple(pairs.shape)} "
                         f"{pairs.dtype}")
    dev = _check_args(pairs, idx, (torch.int32,))
    n_rows = pairs.shape[0] - 1
    steps = int(steps)
    if not 0 <= steps <= _INT_MAX:
        raise ValueError(f"steps={steps} out of range")
    if dev == "cpu":
        return chase_walk_plain(pairs, idx, steps)
    n = idx.shape[0]
    if n < 1 or not 1 <= n_rows <= STAGE_MAX_ROWS:
        raise ValueError(f"the staged walk takes at least 1 lane and 1-{STAGE_MAX_ROWS} rows, "
                         f"got {n} and {n_rows}")
    out = torch.empty(n, dtype=torch.float32, device=pairs.device)
    cuda_build.raise_on_error(_library().shimmer_chase_walk(
        pairs.data_ptr(), n_rows, idx.data_ptr(), n, steps, out.data_ptr(),
        cuda_build.stream_of(pairs)), "chase_walk")
    chase_walk.launches["chase_walk"] += 1
    return out


chase_walk.launches = {"chase_walk": 0}


def row_scatter_add(grad, idx, n_rows: int):
    """``torch.zeros(n_rows, W).index_put_((idx,), grad, accumulate=True)``
    of (N, W) float32 gradient rows, W in [SCATTER_MIN_WIDTH,
    SCATTER_MAX_WIDTH], and (N,) int64 ids in [0, n_rows), at
    most SCATTER_MAX_ROWS rows -> (n_rows, W).  On the card one launch
    that adds each row's lanes from 0 in lane order, the same bits as
    torch's own there, and in which an id outside [0, n_rows) adds
    nothing; on the CPU the plain version, in the same order (it raises on
    such an id)."""
    n_rows = int(n_rows)
    if grad.dim() != 2 or idx.dim() != 1 or grad.shape[0] != idx.shape[0]:
        raise ValueError(f"grad must be (N, W) and idx (N,), got {tuple(grad.shape)} and "
                         f"{tuple(idx.shape)}")
    if grad.dtype != torch.float32:
        raise TypeError(f"grad has dtype {grad.dtype}, expected torch.float32")
    if idx.dtype != torch.int64:
        raise TypeError(f"idx has dtype {idx.dtype}, expected torch.int64")
    if idx.device != grad.device:
        raise ValueError(f"idx is on {idx.device}, grad on {grad.device}")
    if not grad.is_contiguous() or not idx.is_contiguous():
        raise ValueError("grad and idx must be contiguous")
    width = grad.shape[1]
    if not 1 <= n_rows <= SCATTER_MAX_ROWS or not SCATTER_MIN_WIDTH <= width <= SCATTER_MAX_WIDTH:
        raise ValueError(f"{n_rows} rows of {width}: expected 1-{SCATTER_MAX_ROWS} rows of "
                         f"{SCATTER_MIN_WIDTH}-{SCATTER_MAX_WIDTH} floats")
    if idx.shape[0] > _INT_MAX:
        raise ValueError("the lanes must fit int32")
    if grad.device.type == "cpu":
        return row_scatter_add_plain(grad, idx, n_rows)
    if grad.device.type != "cuda":
        raise ValueError(f"no scatter-add for device {grad.device}")
    out = torch.empty(n_rows, width, dtype=torch.float32, device=grad.device)
    cuda_build.raise_on_error(_library().shimmer_row_scatter_add(
        grad.data_ptr(), idx.data_ptr(), idx.shape[0], n_rows, width, out.data_ptr(),
        cuda_build.stream_of(grad)), "row_scatter_add")
    row_scatter_add.launches["row_scatter_add"] += 1
    return out


row_scatter_add.launches = {"row_scatter_add": 0}

# The kernels of the gather experiments (experiments/gather.py).
WRAPPERS = (row_gather, row_gather_cols, row_gather_sum, row_gather_col_sum, row_chase, chase_walk)

# The registry's counts of the small-table gathers under grad
# (utils/stats.py): backwards taken by the kernel, and gathers left to
# aten's backward, by reason.
BACKWARD_KERNEL = "Gather/Backward kernel"
BACKWARD_ATEN = "Gather/Backward aten"


def backward_reason(device_type: str, dtype, shape, lanes: int) -> str | None:
    """Why the backward of a gather of ``lanes`` rows from a table of
    ``shape`` and ``dtype`` on ``device_type`` keeps aten's, or None where
    :func:`row_scatter_add` takes it: a 2-D float32 table on the card of at
    most SCATTER_MAX_ROWS rows of SCATTER_MIN_WIDTH-SCATTER_MAX_WIDTH
    floats (aten adds those in lane order too; a 1-float row goes to its
    parallel kernel), fewer than 2^31 lanes."""
    if device_type != "cuda":
        return "cpu"
    if len(shape) != 2 or not SCATTER_MIN_WIDTH <= shape[1] <= SCATTER_MAX_WIDTH:
        return "columns"
    if shape[0] > SCATTER_MAX_ROWS:
        return "rows"
    if dtype != torch.float32:
        return "dtype"
    if lanes > _INT_MAX:
        return "lanes"
    return None


class _GatherRows(torch.autograd.Function):
    """``table[idx]`` whose backward is :func:`row_scatter_add`."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        return table[idx]

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        stats.counter(BACKWARD_KERNEL if grad.is_cuda else f"{BACKWARD_ATEN}: cpu").add(1)
        width = grad.shape[-1]
        return row_scatter_add(grad.reshape(-1, width).contiguous(), idx.reshape(-1),
                               ctx.n_rows), None


def gather_rows(table, idx):
    """``table[idx]`` for int64 ids ``idx`` (any shape) within the table.
    Under grad, where :func:`backward_reason` allows, its backward is one
    :func:`row_scatter_add` launch in place of aten's sort and serial walk
    (the same bits); the registry counts each such backward under
    ``Gather/Backward kernel`` and each other gather under grad under
    ``Gather/Backward aten: <reason>``."""
    if not (table.requires_grad and torch.is_grad_enabled()):
        return table[idx]
    reason = backward_reason(table.device.type, table.dtype, table.shape, idx.numel())
    if reason is not None:
        stats.counter(f"{BACKWARD_ATEN}: {reason}").add(1)
        return table[idx]
    return _GatherRows.apply(table, idx)


def launch_counts() -> dict:
    """Kernel launches by kernel name, over the experiments' wrappers."""
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


def row_gather_col_sum_plain(table, idx, col: int, repeats: int = 1):
    """Plain torch version of :func:`row_gather_col_sum` (torch's own
    reduction order, then one multiplication)."""
    ok, safe = _in_range(idx, table.shape[0])
    return torch.where(ok, table[safe, int(col)], 0.0).sum() * float(repeats)


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


def row_scatter_add_plain(grad, idx, n_rows: int):
    """Plain torch version of :func:`row_scatter_add`: ``index_add_``,
    which on the CPU adds each lane to its row one at a time in lane order,
    as the kernel does.  (The CPU's ``index_put_(accumulate=True)``, the
    backward of ``table[idx]`` there, adds in that order only up to a few
    tens of thousands of values, and with threads in any order beyond.)"""
    out = torch.zeros(int(n_rows), grad.shape[1], dtype=grad.dtype, device=grad.device)
    return out.index_add_(0, idx, grad)


def chase_pairs_plain(table):
    """Each row's (next index, row sum) of a chase over ``table``, and at
    index R those of the row of zeros an out-of-range index reads: (R + 1,
    2) int32, column 1 the bits of the float32 sum row[1] + ... + row[8]
    added left to right; a next index out of [0, R) is R."""
    n_rows = table.shape[0]
    v = torch.cat([table[:, :CHASE_COLS].float(),
                   torch.zeros(1, CHASE_COLS, dtype=torch.float32, device=table.device)])
    s = v[:, 1]
    for j in range(2, CHASE_COLS):
        s = s + v[:, j]
    x0 = v[:, 0]
    nxt = torch.where((x0 > -1.0) & (x0 < n_rows), x0.to(torch.int32), n_rows)
    return torch.stack([nxt.to(torch.int32), s.view(torch.int32)], 1)


def chase_walk_plain(pairs, idx, steps: int):
    """Plain torch version of :func:`chase_walk`."""
    n_rows = pairs.shape[0] - 1
    nxt = pairs[:, 0].long()
    sums = pairs[:, 1].contiguous().view(torch.float32)
    r = torch.where((idx >= 0) & (idx < n_rows), idx, n_rows).long()
    acc = torch.zeros(idx.shape[0], dtype=torch.float32, device=pairs.device)
    for _ in range(int(steps)):
        acc = acc + sums[r]
        r = nxt[r]
    return acc
