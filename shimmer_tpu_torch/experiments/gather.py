"""Row-gather micro-benchmarks: the port's counterpart of the reference's
gather experiments, run through the hand-written kernels of
``ops/gather.py`` at the reference scripts' own sizes.

    python -m shimmer_tpu_torch.experiments.gather          # on the CUDA card

Cases, by kernel-table row (PERF.md) and the reference script they mirror:

* 6A/6B/6B2 (``experiments/pallas_gather.py``): the float32 chase, K=32,
  R in {2048, 16384}, N in {8192, 131072}; the kernel is 6B and 6B2 (one
  function, two TPU fetch strategies), the plain torch chase is 6A (the
  reference's XLA ``jnp.take`` loop);
* 6C: the same chase over the table rounded to bf16, K=8;
* 6D: the gather-sum at N=8192 (the reference's value is 4 * out[1]; its
  bound counts what 6D needs, one sector of column 1 a row, though the
  kernel sums all W columns);
* 6E: one lane from index 0, K=4096 (the latency of a dependent read);
* 7F (``pallas_gather2.py``): the gather and the K=32 chase with N = R,
  R in {1024, 8192, 16384}; 7G: the gather from the transposed (W, R)
  table, R in {1024, 8192}; 7H: the chase with narrow rows, R=16384,
  W in {16, 32, 64, 128}, N in {131072, 524288};
* 8/9 (``exp_pallas_gather.py``, ``exp_pallas_gather2.py``): the gather,
  and (9) the gather-sum, R=16384, N=131072, W=128.

Tables and indices come from ``numpy.random.default_rng`` seeded by
``SEED`` and the case's sizes: a standard-normal (R, W) table whose
column 0 holds row indices where the reference's table does (its
``table_np[:, 0]``: rows 6 and 7F, 7H), and uniform indices in [0, R).
Each case runs the kernel and its plain version on the same tensors and compares them: bit-equal for the gathers
and the chases, within ``SUM_RTOL`` for the gather-sum.  It prints one
line in the reference's units (us per step and ns per lane for the
chases, GB/s for the gathers, the checksum) and returns the rows.  With
``device="cpu"`` the wrappers run the plain versions and the times are
host-clock times of the CPU, not of a card.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from shimmer_tpu_torch.config import resolve_device
from shimmer_tpu_torch.ops import gather as g

# The gather-sum's tolerance, per column: |kernel - plain| <= SUM_RTOL *
# sum_i |T[idx_i, c]|.  The kernel adds in chunks of 64 rows and then
# across blocks by atomics in a varying order; torch reduces by its own
# tree.  Both orders stay within about sqrt(N) float32 roundings of the
# partial sums (~1e-7 of sum |x| at N=131072); one row left out or added
# twice moves a column by |T[i, c]|, about 8e-6 of sum |x| there.
SUM_RTOL = 1e-6
# The seed of every case's table and indices.
SEED = 0
# Timed launches of a kernel per case, after one warm-up (the plain
# version: 2).
REPS = 20
KERNELS = ("row_gather", "row_gather_cols", "row_gather_sum", "row_chase_f32",
           "row_chase_bf16")
# Float operations per chase step: 8 additions and the index conversion.
CHASE_OPS_PER_STEP = 9
# Bytes of one memory sector, the least a row read can move.
SECTOR_BYTES = 32


@dataclasses.dataclass(frozen=True)
class Case:
    row: str           # kernel-table row(s) it measures
    kernel: str        # one of KERNELS
    n_rows: int        # R
    n: int             # lanes (indices)
    width: int = 128   # W
    steps: int = 1     # K: chase steps; 6D's repeat count
    index_col: bool = True  # column 0 of the table holds row indices

    @property
    def name(self) -> str:
        return f"{self.row} {self.kernel} R={self.n_rows} N={self.n} W={self.width} K={self.steps}"


def cases() -> list[Case]:
    """The reference scripts' cases, at their own sizes."""
    out = []
    for r in (2048, 16384):
        for n in (8192, 131072):
            out.append(Case("6A/6B/6B2", "row_chase_f32", r, n, steps=32))
            out.append(Case("6C", "row_chase_bf16", r, n, steps=8))
            if n <= 8192:
                out.append(Case("6D", "row_gather_sum", r, n, steps=4))
        out.append(Case("6E", "row_chase_f32", r, 1, steps=4096))
    for r in (1024, 8192, 16384):
        out.append(Case("7F", "row_gather", r, r))
        out.append(Case("7F", "row_chase_f32", r, r, steps=32))
    for r in (1024, 8192):
        out.append(Case("7G", "row_gather_cols", r, r, index_col=False))
    for w in (16, 32, 64, 128):
        for n in (131072, 524288):
            out.append(Case("7H", "row_chase_f32", 16384, n, width=w, steps=32))
    out.append(Case("8/9", "row_gather", 16384, 131072, index_col=False))
    out.append(Case("9", "row_gather_sum", 16384, 131072, index_col=False))
    return out


def make_inputs(case: Case, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(table, idx) of a case on ``device``: the table (R, W) float32 (bf16
    for the bf16 chase, rounded to nearest even; (W, R) for the transposed
    gather), idx (N,) int32 (6E: one lane at index 0)."""
    rng = np.random.default_rng([SEED, case.n_rows, case.n, case.width])
    table = rng.standard_normal((case.n_rows, case.width)).astype(np.float32)
    if case.index_col:
        table[:, 0] = rng.integers(0, case.n_rows, case.n_rows).astype(np.float32)
    if case.row == "6E":
        idx = np.zeros(1, np.int32)
    else:
        idx = rng.integers(0, case.n_rows, case.n).astype(np.int32)
    if case.kernel == "row_gather_cols":
        table = np.ascontiguousarray(table.T)
    t = torch.from_numpy(table).to(device)
    if case.kernel == "row_chase_bf16":
        t = t.to(torch.bfloat16)
    return t, torch.from_numpy(idx).to(device)


def time_ms(fn, device, reps: int = REPS) -> float:
    """Mean milliseconds of fn() after one warm-up call: CUDA events on the
    card, with the launches queued behind a device-side sleep so that the
    host's launch cost stays out of the device time; the host clock on
    the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000 * reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def _functions(case: Case, table, idx):
    """(kernel call, plain call) of a case."""
    if case.kernel == "row_gather":
        return lambda: g.row_gather(table, idx), lambda: g.row_gather_plain(table, idx)
    if case.kernel == "row_gather_cols":
        return lambda: g.row_gather_cols(table, idx), lambda: g.row_gather_cols_plain(table, idx)
    if case.kernel == "row_gather_sum":
        return lambda: g.row_gather_sum(table, idx), lambda: g.row_gather_sum_plain(table, idx)
    return (lambda: g.row_chase(table, idx, case.steps),
            lambda: g.row_chase_plain(table, idx, case.steps))


def run_case(case: Case, table, idx) -> dict:
    """Run one case: the kernel against its plain version on the same
    tensors, both timed, with the work the bound counts (distinct rows
    read, bytes moved once, float operations)."""
    dev = table.device
    kernel, plain = _functions(case, table, idx)
    got = kernel()
    stats = {}
    chase = case.kernel.startswith("row_chase")
    # The chase's plain version also records the rows it read.
    want = g.row_chase_plain(table, idx, case.steps, stats=stats) if chase else plain()
    if case.kernel == "row_gather_sum":
        scale = g.row_gather_plain(table, idx).abs().sum(0)
        err = (got - want).abs()
        ok = bool((err <= SUM_RTOL * scale).all())
        rel_err = float((err / scale).max())
    else:
        err = (got.float() - want.float()).abs()
        ok = torch.equal(got, want)
    ms = time_ms(kernel, dev)
    plain_ms = time_ms(plain, dev, reps=2)

    n_rows, width = table.shape
    if case.kernel == "row_gather_cols":
        n_rows, width = width, n_rows
    elem = table.element_size()
    n = idx.shape[0]
    res = {"name": case.name, "row": case.row, "kernel": case.kernel, "R": n_rows, "N": n,
           "W": width, "K": case.steps, "ok": ok, "max_abs_err": float(err.max()),
           "ms": ms, "plain_ms": plain_ms}
    if chase:
        distinct = int(stats["rows_read"].sum())
        res["oob_lanes"] = int(stats["oob_lanes"].sum())
        res["checksum"] = float(got.sum())
        res["bytes"] = distinct * g.CHASE_COLS * elem + 8 * n
        res["ops"] = CHASE_OPS_PER_STEP * n * case.steps
        res["ns_per_step"] = ms * 1e6 / case.steps
        res["ns_per_lane_step"] = ms * 1e6 / (case.steps * n)
    else:
        ok_idx = idx[(idx >= 0) & (idx < n_rows)]
        distinct = int(torch.unique(ok_idx).numel())
        if case.kernel == "row_gather_sum":
            res["max_rel_err"] = rel_err  # of sum_i |T[idx_i, c]|, against SUM_RTOL
            res["checksum"] = float(case.steps * got[1])
            if case.row == "6D":
                # 6D's function, sum_k sum_i T[idx_i, 1], needs one sector
                # of column 1 a distinct row, idx and one float out.
                res["bytes"] = distinct * SECTOR_BYTES + 4 * n + 4
                res["ops"] = case.steps * n
            else:
                res["bytes"] = distinct * width * elem + 4 * n + 4 * width
                res["ops"] = n * width
            res["ns_per_row"] = ms * 1e6 / n
        else:
            res["checksum"] = float(got.sum())
            res["bytes"] = n * width * 4 + 4 * n + distinct * width * elem
            res["ops"] = 0
            res["out_gb_per_s"] = n * width * 4 / (ms * 1e-3) / 1e9
    res["distinct_rows"] = distinct
    return res


def format_line(res: dict) -> str:
    head = f"  {res['name']:52s}:"
    tail = (f"kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
            f"chk={res['checksum']:.1f} {'exact' if res['max_abs_err'] == 0 else 'max|d|=%g' % res['max_abs_err']}"
            f"{'' if res['ok'] else ' MISMATCH'}")
    if res["kernel"].startswith("row_chase"):
        k = res["K"]
        return (f"{head} {res['ms'] * 1e3 / k:9.3f} us/step ({res['ns_per_lane_step']:8.4f} ns/lane), "
                f"plain {res['plain_ms'] * 1e3 / k:9.3f} us/step; oob lanes {res['oob_lanes']}; {tail}")
    if res["kernel"] == "row_gather_sum":
        return f"{head} {res['ns_per_row']:8.4f} ns/row; {tail}"
    return f"{head} {res['out_gb_per_s']:8.1f} GB/s out; {tail}"


def main(device=None) -> dict:
    """Run every case on ``device`` (default: the CUDA card; raises without
    one) and return {case name: result row}."""
    dev = resolve_device(device)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else f"{dev} (plain torch versions, host clock)")
    print(f"row-gather micro-benchmarks on {where}, seed {SEED}", flush=True)
    rows = {}
    for case in cases():
        table, idx = make_inputs(case, dev)
        res = run_case(case, table, idx)
        print(format_line(res), flush=True)
        rows[case.name] = res
    return rows


if __name__ == "__main__":
    sys.exit(0 if all(r["ok"] for r in main().values()) else 1)
