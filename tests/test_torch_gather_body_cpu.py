"""The gather kernels' own bodies (csrc/gather_body.cuh), compiled for the
host with g++ (csrc/gather_host.cpp), against the port's plain torch
versions (ops/gather.py); and the wrappers' contract on a machine without
a card.

The gathers and the chases are bit-equal: they move values or add them
in the same order (row[1..8] left to right, then into the accumulator),
and g++ builds without FMA contraction.  The gather-sum, in both its forms
(direct: the indices' rows; counted: each row times its count) and in
the form the rule picks, and the one-column sum are bit-equal to a numpy
sum in the kernels' own order (chunks of rows per warp, warps in order
within a block, blocks in order; the one-column sum's shuffle tree), and
within the entry point's SUM_RTOL of the plain versions, which sum in
torch's order.  Every body
reads a row of zeros for an index outside [0, R), as the plain versions
do, including indices that bf16 rounding pushes to R.  The staged chase
(each row's next index and row sum written by a pass, then walked from
shared memory) is bit-equal to the per-lane chase it replaces, for few
lanes with long chains and for many lanes walked by a grid of blocks (the
lanes' partition into chunks over any number of blocks), and the dispatch
rule sends each entry-point case to the form the card runs it in.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from shimmer_tpu_torch.experiments import gather as eg
from shimmer_tpu_torch.ops import cuda_build
from shimmer_tpu_torch.ops import gather as g
from shimmer_tpu_torch.ops.cuda_build import CSRC

torch.set_num_threads(1)

R = 96
N = 1000
# The gather-sums' bounds the host build reports, as the wrapper holds them.
SUM_BOUNDS = ("shimmer_gather_sum_max_blocks", "shimmer_gather_sum_counted_max_n",
              "shimmer_gather_sum_counted_indices_per_row", "shimmer_gather_sum_counted_min_rows",
              "shimmer_gather_sum_counted_min_width", "shimmer_col_sum_max_blocks",
              "shimmer_col_sum_max_repeats")
# The form the card runs each gather-sum case of the entry point in, (R, N)
# -> counted, by the timing of both forms (PERF.md).
EXPECTED_FORMS = {(2048, 8192): False, (16384, 8192): False, (16384, 131072): True}


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host build of the kernel bodies needs it")
    out = tmp_path_factory.mktemp("gather_host") / "libgather_host.so"
    subprocess.run(
        [gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
         "-I", str(CSRC), str(CSRC / "gather_host.cpp"), "-o", str(out)],
        check=True, capture_output=True, timeout=300,
    )
    lib = ctypes.CDLL(str(out))
    p, ci = ctypes.c_void_p, ctypes.c_int
    for name in ("shimmer_row_gather_host", "shimmer_row_gather_cols_host",
                 "shimmer_row_gather_sum_host"):
        getattr(lib, name).argtypes = [p, ci, ci, p, ci, p]
        getattr(lib, name).restype = ci
    lib.shimmer_row_gather_sum_form_host.argtypes = [p, ci, ci, p, ci, ci, p]
    lib.shimmer_row_gather_col_sum_host.argtypes = [p, ci, ci, p, ci, ci, ci, p]
    lib.shimmer_gather_sum_counted_host.argtypes = [ci, ci, ci]
    lib.shimmer_row_chase_host.argtypes = [ci, p, ci, ci, p, ci, ci, p]
    lib.shimmer_row_chase_staged_host.argtypes = [ci, p, ci, ci, p, ci, ci, ci, p]
    lib.shimmer_chase_pairs_host.argtypes = [ci, p, ci, ci, p]
    lib.shimmer_row_chase_staged.argtypes = [ci, ci, ci]
    for name in ("shimmer_gather_sum_rows_per_warp", "shimmer_gather_sum_warps",
                 "shimmer_gather_sum_max_width", "shimmer_gather_cols_stage_max_rows",
                 "shimmer_chase_pairs_host", "shimmer_row_chase_staged",
                 "shimmer_chase_stage_max_lanes", "shimmer_chase_stage_max_rows",
                 "shimmer_chase_stage_min_steps", "shimmer_chase_wide_min_steps",
                 "shimmer_chase_many_lanes", "shimmer_chase_many_lanes_min_steps",
                 "shimmer_chase_walk_threads", "shimmer_row_chase_host",
                 "shimmer_row_chase_staged_host", "shimmer_row_gather_sum_form_host",
                 "shimmer_row_gather_col_sum_host", "shimmer_gather_sum_counted_host",
                 *SUM_BOUNDS):
        getattr(lib, name).restype = ci
    lib.shimmer_chase_walk_threads.argtypes = [ci]
    assert lib.shimmer_gather_sum_max_width() == g.SUM_MAX_WIDTH
    assert (lib.shimmer_chase_stage_max_lanes(), lib.shimmer_chase_stage_max_rows(),
            lib.shimmer_chase_stage_min_steps(), lib.shimmer_chase_wide_min_steps(),
            lib.shimmer_chase_many_lanes(), lib.shimmer_chase_many_lanes_min_steps()) == (
                g.STAGE_MAX_LANES, g.STAGE_MAX_ROWS, g.STAGE_MIN_STEPS, g.WIDE_MIN_STEPS,
                g.MANY_LANES, g.MANY_LANES_MIN_STEPS)
    assert tuple(getattr(lib, name)() for name in SUM_BOUNDS) == (
        g.SUM_MAX_BLOCKS, g.SUM_COUNTED_MAX_N, g.SUM_COUNTED_INDICES_PER_ROW,
        g.SUM_COUNTED_MIN_ROWS, g.SUM_COUNTED_MIN_WIDTH, g.COL_SUM_MAX_BLOCKS,
        g.COL_SUM_MAX_REPEATS)
    return lib


def table_and_indices(seed, width, n_rows=R, n=N, finite=False):
    """A chase table (column 0 row indices) with a few bad column-0 values
    (``finite``: no NaN or inf among them), and indices with a few outside
    [0, R)."""
    rng = np.random.default_rng(seed)
    tab = rng.standard_normal((n_rows, width)).astype(np.float32)
    tab[:, 0] = rng.integers(0, n_rows, n_rows)
    bad = [n_rows, -1.0, -0.5, n_rows - 0.5, 1e10, -1e10] + ([] if finite else [np.nan, np.inf])
    tab[rng.choice(n_rows, len(bad), replace=False), 0] = bad
    idx = rng.integers(0, n_rows, n).astype(np.int32)
    idx[rng.choice(n, 6, replace=False)] = [-1, n_rows, n_rows + 7, -(2**31), 2**31 - 1, 0]
    return torch.from_numpy(tab), torch.from_numpy(idx)


def call(fn, *args):
    assert fn(*args) == 0


def bits_equal(a, b):
    """Equal bit for bit (NaN payloads included)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("width", [4, 12, 128])
def test_gather_body_matches_plain(host, width):
    tab, idx = table_and_indices(0, width)
    out = torch.empty(N, width)
    call(host.shimmer_row_gather_host, tab.data_ptr(), R, width, idx.data_ptr(), N, out.data_ptr())
    want = g.row_gather_plain(tab, idx)
    assert bits_equal(out, want)
    bad = (idx < 0) | (idx >= R)
    assert bool(bad.any()) and bool((out[bad] == 0).all())


# (W, N, R): the transposed gather's two forms (staged for R up to
# shimmer_gather_cols_stage_max_rows, direct beyond) on odd and even W and
# ragged N, N past one staged chunk of 2048 among them; the first two keep
# their earlier ids.
COLS_CASES = {"9": (9, N, R), "128": (128, N, R), "1_n77": (1, 77, R), "8_n1": (8, 1, R),
              "13_n333": (13, 333, R), "17_n1000": (17, N, R), "127_n77": (127, 77, R),
              "3_n4099": (3, 4099, R), "3_n77_r12289": (3, 77, 12289),
              "17_n1000_r13000": (17, N, 13000)}


@pytest.mark.parametrize("width, n, n_rows", list(COLS_CASES.values()), ids=list(COLS_CASES))
def test_gather_cols_body_matches_plain(host, width, n, n_rows):
    tab, idx = table_and_indices(1, width, n_rows=n_rows, n=max(n, 8))
    idx = idx[:n].contiguous()
    tab_t = tab.T.contiguous()
    out = torch.empty(width, n)
    out.view(torch.int32).fill_(0x7FBADBAD)  # a NaN no table value holds: unwritten
    call(host.shimmer_row_gather_cols_host, tab_t.data_ptr(), n_rows, width, idx.data_ptr(), n,
         out.data_ptr())
    assert bits_equal(out, g.row_gather_cols_plain(tab_t, idx))


def test_gather_cols_cases_reach_both_forms_and_ragged_groups(host):
    """The cases above take both forms, and the staged one a last column
    pair that holds one column and a last chunk that is only partly
    filled."""
    stage_max = host.shimmer_gather_cols_stage_max_rows()
    cases = COLS_CASES.values()
    assert any(r <= stage_max for _, _, r in cases) and any(r > stage_max for _, _, r in cases)
    assert any(w % 2 for w, _, r in cases if r <= stage_max)
    assert any(n > 2048 and n % 2048 for _, n, r in cases if r <= stage_max)


def chase_table(dtype, width, seed):
    tab, idx = table_and_indices(seed, width)
    if dtype == "bf16":
        # 8 significand bits: 95.5 -> 96 = R, beside the bad values above.
        tab[:5, 0] = R - 0.5
        return tab.to(torch.bfloat16), idx
    return tab, idx


@pytest.mark.parametrize("width", [16, 128])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_chase_body_matches_plain(host, dtype, width):
    tab, idx = chase_table(dtype, width, 2)
    steps = 24
    out = torch.empty(N)
    call(host.shimmer_row_chase_host, int(dtype == "bf16"), tab.data_ptr(), R, width,
         idx.data_ptr(), N, steps, out.data_ptr())
    stats = {}
    want = g.row_chase_plain(tab, idx, steps, stats=stats)
    assert torch.equal(out, want)
    # The trap lanes are there: some lanes met an out-of-range index.
    assert 0 < int(stats["oob_lanes"].sum()) < N


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_chase_pairs_body_matches_plain(host, dtype):
    """The staged chase's pass: each row's (next index, row sum) and the
    pair of the row of zeros at R, bit for bit (the table's bad column-0
    values give next index R)."""
    tab, _ = chase_table(dtype, 128, 7)
    got = torch.empty(R + 1, 2, dtype=torch.int32)
    call(host.shimmer_chase_pairs_host, int(dtype == "bf16"), tab.data_ptr(), R, 128,
         got.data_ptr())
    want = g.chase_pairs_plain(tab)
    assert torch.equal(got, want)
    assert got[R].tolist() == [0, 0] and int((got[:R, 0] == R).sum()) >= 6


# (start indices, steps): one lane from 0, a start out of range each way,
# a lane whose first row points out of the table, and many lanes.
STAGED_CASES = {"n1_from_0": ([0], (0, 1, 4096)), "n1_start_high": ([R + 3], (0, 1, 4096)),
                "n1_start_low": ([-(2**31)], (1, 4096)), "n1_first_row_out": ([1], (1, 2, 4096)),
                "many_lanes": (None, (0, 1, 300))}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("start, steps_list", list(STAGED_CASES.values()), ids=list(STAGED_CASES))
def test_staged_chase_matches_lane_and_plain(host, dtype, start, steps_list):
    """The staged walk over the pass's pairs against the per-lane chase body
    and the plain version, bit for bit, at the cases' step counts (4,096:
    6E's)."""
    tab, idx = chase_table(dtype, 128, 8)
    tab = tab.clone()
    tab[1, 0] = float(R)  # row 1's next index is out of range: the next step reads zeros
    if start is not None:
        idx = torch.tensor(start, dtype=torch.int32)
    n = idx.shape[0]
    for steps in steps_list:
        staged, lane = torch.empty(n), torch.empty(n)
        call(host.shimmer_row_chase_staged_host, int(dtype == "bf16"), tab.data_ptr(), R, 128,
             idx.data_ptr(), n, steps, 1, staged.data_ptr())
        call(host.shimmer_row_chase_host, int(dtype == "bf16"), tab.data_ptr(), R, 128,
             idx.data_ptr(), n, steps, lane.data_ptr())
        stats = {}
        want = g.row_chase_plain(tab, idx, steps, stats=stats)
        assert bits_equal(staged, want), steps
        assert bits_equal(lane, want), steps
        assert bits_equal(g.chase_walk(g.chase_pairs_plain(tab), idx, steps), want), steps
        if steps > 1 and start in ([1], [R + 3]):
            assert bool(stats["oob_lanes"].all())


# (lanes, blocks): one chunk of lanes or a few, the last one ragged, over
# one block or several (a block takes every blocks-th chunk), more blocks
# than chunks among them; chunks of 512 lanes up to 16,384 lanes and of
# 1,024 beyond (None: one chunk, 1: one chunk and a lane).
WIDE_CASES = {"n33_b1": (33, 1), "chunk_b2": (None, 2), "chunk_plus1_b2": (1, 2),
              "n3000_b2": (3000, 2), "n5000_b3": (5000, 3), "n2500_b7": (2500, 7),
              "n16385_b5": (16385, 5)}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n, blocks", list(WIDE_CASES.values()), ids=list(WIDE_CASES))
def test_wide_staged_chase_matches_lane_and_plain(host, dtype, n, blocks):
    """The staged walk of many lanes as the card's grid runs it (chunks of
    lanes dealt to the blocks in turn, a thread's lanes side by side)
    against the per-lane body and the plain version, bit for bit: out-of-
    range starts, rows pointing out of the table and (bf16) indices
    rounded to R among the lanes; every lane written once."""
    chunk = host.shimmer_chase_walk_threads(512)
    n = chunk if n is None else (chunk + 1 if n == 1 else n)
    assert host.shimmer_chase_walk_threads(n) == (512 if n <= 16384 else 1024)
    tab, idx = chase_table(dtype, 128, 9)
    rng = np.random.default_rng(n)
    idx = torch.from_numpy(rng.integers(-4, R + 4, n).astype(np.int32))
    steps = 24
    staged, lane = torch.full((n,), float("nan")), torch.empty(n)
    call(host.shimmer_row_chase_staged_host, int(dtype == "bf16"), tab.data_ptr(), R, 128,
         idx.data_ptr(), n, steps, blocks, staged.data_ptr())
    call(host.shimmer_row_chase_host, int(dtype == "bf16"), tab.data_ptr(), R, 128,
         idx.data_ptr(), n, steps, lane.data_ptr())
    stats = {}
    want = g.row_chase_plain(tab, idx, steps, stats=stats)
    assert bits_equal(staged, want) and bits_equal(lane, want)
    assert bits_equal(g.chase_walk(g.chase_pairs_plain(tab), idx, steps), want)
    assert 0 < int(stats["oob_lanes"].sum()) < n


def test_chase_dispatch_rule(host):
    """The card stages 6E (one lane, 4,096 steps) and, by the timing of
    every chase case in both forms, every wider chase but 6C's at N =
    8,192 (K = 8, faster per lane); the host build's rule and the wrapper's
    agree at and around every bound."""
    staged = {c.name: bool(host.shimmer_row_chase_staged(c.n_rows, c.n, c.steps))
              for c in eg.cases() if c.kernel.startswith("row_chase")}
    assert {n for n, s in staged.items() if not s} == {
        c.name for c in eg.cases() if c.row == "6C" and c.n == 8192}
    assert any(n.startswith("6E") for n in staged) and any(n.startswith("7F") for n in staged)
    assert any(n.startswith("7H") for n in staged) and any(n.startswith("6A") for n in staged)
    lanes, rows, steps = g.STAGE_MAX_LANES, g.STAGE_MAX_ROWS, g.STAGE_MIN_STEPS
    for n_rows in (1, 64, 16384, 16385, 64 * steps, 64 * steps + 64, rows, rows + 1):
        for n in (0, 1, lanes, lanes + 1, g.MANY_LANES - 1, g.MANY_LANES):
            for k in (0, 1, g.MANY_LANES_MIN_STEPS - 1, g.MANY_LANES_MIN_STEPS,
                      g.WIDE_MIN_STEPS - 1, g.WIDE_MIN_STEPS, steps - 1, steps,
                      n_rows // 64 - 1, n_rows // 64, 4096):
                want = g.chase_staged(n_rows, n, k)
                assert bool(host.shimmer_row_chase_staged(n_rows, n, k)) == want, (n_rows, n, k)
    assert g.chase_staged(16384, 1, 4096) and g.chase_staged(16384, 131072, 32)
    assert g.chase_staged(16384, 131072, 8) and not g.chase_staged(16384, 8192, 8)
    assert not g.chase_staged(rows + 1, 1, 2**20) and g.chase_staged(rows, 1, 2**20)
    assert not g.chase_staged(rows + 1, 131072, 32) and not g.chase_staged(16384, 33, 31)


def sum_in_kernel_order(tab, idx, counted, host):
    """numpy float32 sum in the kernels' order: item i is row idx[i] with
    weight 1 (direct; 0 out of range) or row i with weight count[i]
    (counted); chunks of K items to warp slots in turn, a warp's items in
    order (acc + float(weight) * row, skipping weight 0), the warps of a
    block in order, the blocks in order."""
    tab, idx = tab.numpy(), idx.numpy()
    n_rows, width = tab.shape
    k, warps = host.shimmer_gather_sum_rows_per_warp(), host.shimmer_gather_sum_warps()
    ok = (idx >= 0) & (idx < n_rows)
    counts = np.bincount(idx[ok], minlength=n_rows)
    items = n_rows if counted else len(idx)
    chunks = -(-items // k)
    blocks = min(max(-(-chunks // warps), 1), host.shimmer_gather_sum_max_blocks())
    total = None
    for b in range(blocks):
        block = None
        for w in range(warps):
            acc = np.zeros(width, np.float32)
            for c in range(b * warps + w, chunks, blocks * warps):
                for i in range(c * k, min((c + 1) * k, items)):
                    row, weight = (i, counts[i]) if counted else (idx[i], int(ok[i]))
                    if weight:
                        acc = acc + np.float32(weight) * tab[row]
            block = acc if block is None else block + acc
        total = block if total is None else total + block
    return total


def sum_indices(n, width, seed=3):
    """A finite table and n indices with repeats, some outside [0, R)."""
    tab, idx = table_and_indices(seed, width, n=max(n, 8), finite=True)
    return tab, idx[:n].contiguous()


def check_sum(host, tab, idx, out, counted):
    np.testing.assert_array_equal(out.numpy(), sum_in_kernel_order(tab, idx, counted, host))
    plain = g.row_gather_sum_plain(tab, idx)
    scale = g.row_gather_plain(tab, idx).abs().sum(0)
    assert bool(((out - plain).abs() <= eg.SUM_RTOL * scale).all())


@pytest.mark.parametrize("n", [1, 64, 1000, 1536])
@pytest.mark.parametrize("width", [8, 128])
def test_gather_sum_body_in_its_order(host, width, n):
    """The gather-sum in the form the rule picks for (R, N, W), as the card
    runs it."""
    tab, idx = sum_indices(n, width)
    out = torch.empty(width)
    call(host.shimmer_row_gather_sum_host, tab.data_ptr(), R, width, idx.data_ptr(), n,
         out.data_ptr())
    check_sum(host, tab, idx, out, g.gather_sum_counted(R, n, width))


@pytest.mark.parametrize("n", [0, 1, 31, 1000, 8192])
@pytest.mark.parametrize("width", [8, 128])
@pytest.mark.parametrize("form", ["direct", "counted"])
def test_gather_sum_forms_in_their_order(host, form, width, n):
    """Each form of the gather-sum, whatever the rule picks: bit-equal to
    numpy in its order and within SUM_RTOL of the plain version; repeated
    indices and indices outside [0, R) (each way) among them; no index
    gives zeros."""
    tab, idx = sum_indices(n, width)
    if n >= 1000:
        assert bool(((idx < 0) | (idx >= R)).any()) and len(set(idx.tolist())) < n
    out = torch.full((width,), float("nan"))
    call(host.shimmer_row_gather_sum_form_host, tab.data_ptr(), R, width, idx.data_ptr(), n,
         int(form == "counted"), out.data_ptr())
    check_sum(host, tab, idx, out, form == "counted")
    if n == 0:
        assert bits_equal(out, torch.zeros(width))


def col_sum_in_kernel_order(tab, idx, col, repeats, host):
    """numpy float32 one-column sum in the kernel's order: each thread's
    values in order, each warp's shuffle-down tree, the warps, the blocks,
    times float(repeats)."""
    tab, idx = tab.numpy(), idx.numpy()
    n_rows, n = tab.shape[0], len(idx)
    threads_per_block = host.shimmer_col_sum_threads()
    blocks = min(max(-(-n // threads_per_block), 1), host.shimmer_col_sum_max_blocks())
    threads = blocks * threads_per_block
    ok = (idx >= 0) & (idx < n_rows)
    vals = np.where(ok, tab[np.where(ok, idx, 0), col], np.float32(0)).astype(np.float32)
    s = np.zeros(threads, np.float32)
    for k in range(0, n, threads):
        part = vals[k:k + threads]
        s[:len(part)] = s[:len(part)] + part
    lanes = s.reshape(-1, 32)
    for off in (16, 8, 4, 2, 1):
        lanes[:, :32 - off] = lanes[:, :32 - off] + lanes[:, off:]
    warp_sums = lanes[:, 0].reshape(blocks, threads_per_block // 32)
    total = None
    for b in range(blocks):
        block = warp_sums[b, 0]
        for w in range(1, warp_sums.shape[1]):
            block = block + warp_sums[b, w]
        total = block if total is None else total + block
    return np.float32(repeats) * total


@pytest.mark.parametrize("n", [0, 1, 31, 1000, 8192])
@pytest.mark.parametrize("width", [8, 128])
def test_col_sum_body_in_its_order(host, width, n):
    """The one-column sum (6D, K = 4 repeats) bit-equal to numpy in the
    kernel's order and within SUM_RTOL of the plain version, at column 1
    and the last column; indices outside [0, R) add 0."""
    tab, idx = sum_indices(n, width, seed=4)
    for col in (1, width - 1):
        out = torch.full((), float("nan"))
        call(host.shimmer_row_gather_col_sum_host, tab.data_ptr(), R, width, idx.data_ptr(), n,
             col, 4, out.data_ptr())
        np.testing.assert_array_equal(out.numpy(), col_sum_in_kernel_order(tab, idx, col, 4, host))
        plain = g.row_gather_col_sum_plain(tab, idx, col, 4)
        scale = 4 * g.row_gather_col_sum_plain(tab.abs(), idx, col)
        assert float((out - plain).abs()) <= eg.SUM_RTOL * float(scale)
        if n == 0:
            assert float(out) == 0.0


def test_gather_sum_rule(host):
    """The host build's rule and the wrapper's agree at and around every
    bound; the entry point's gather-sum cases take the form the card was
    measured faster in (PERF.md)."""
    per_row, min_rows, width = (g.SUM_COUNTED_INDICES_PER_ROW, g.SUM_COUNTED_MIN_ROWS,
                                g.SUM_COUNTED_MIN_WIDTH)
    hi = g.SUM_COUNTED_MAX_N
    for n_rows in (1, 96, 2048, min_rows - 1, min_rows, min_rows + 1, 131072, hi // per_row,
                   hi // per_row + 1, 2**31 - 1):
        for n in (0, 1, per_row * n_rows - 1, per_row * n_rows, per_row * n_rows + 1, 131072,
                  hi, hi + 1):
            if not 0 <= n < 2**31:
                continue
            for w in (4, 8, width - 4, width):
                want = g.gather_sum_counted(n_rows, n, w)
                assert bool(host.shimmer_gather_sum_counted_host(n_rows, n, w)) == want
    assert g.gather_sum_counted(min_rows, per_row * min_rows, width)
    assert not g.gather_sum_counted(min_rows - 1, hi, width)
    assert not g.gather_sum_counted(min_rows, per_row * min_rows - 1, width)
    assert not g.gather_sum_counted(min_rows, hi, width - 4)
    assert not g.gather_sum_counted(min_rows, hi + 1, width)
    forms = {(c.n_rows, c.n): g.gather_sum_counted(c.n_rows, c.n, c.width)
             for c in eg.cases() if c.kernel == "row_gather_sum"}
    assert forms == EXPECTED_FORMS


def test_host_body_rejects_what_the_kernels_do_not_take(host):
    tab, idx = table_and_indices(4, 128)
    out = torch.empty(N * 128)
    p = (tab.data_ptr(), R)
    assert host.shimmer_row_gather_host(*p, 6, idx.data_ptr(), N, out.data_ptr()) == -1
    assert host.shimmer_row_gather_sum_host(*p, 132, idx.data_ptr(), N, out.data_ptr()) == -1
    assert host.shimmer_row_gather_sum_form_host(*p, 6, idx.data_ptr(), N, 0, out.data_ptr()) == -1
    assert host.shimmer_row_gather_sum_form_host(*p, 128, idx.data_ptr(), N, 2,
                                                 out.data_ptr()) == -1
    assert host.shimmer_row_gather_sum_form_host(*p, 128, idx.data_ptr(), 2**24, 1,
                                                 out.data_ptr()) == -1
    for col, repeats in ((-1, 4), (128, 4), (1, -1), (1, 2**24 + 1)):
        assert host.shimmer_row_gather_col_sum_host(*p, 128, idx.data_ptr(), N, col, repeats,
                                                    out.data_ptr()) == -1
    assert host.shimmer_row_chase_host(0, *p, 12, idx.data_ptr(), N, 4, out.data_ptr()) == -1
    assert host.shimmer_row_chase_host(2, *p, 128, idx.data_ptr(), N, 4, out.data_ptr()) == -1
    assert host.shimmer_row_chase_staged_host(0, *p, 12, idx.data_ptr(), 1, 4, 1,
                                              out.data_ptr()) == -1
    assert host.shimmer_row_chase_staged_host(0, *p, 128, idx.data_ptr(), 1, 4, 0,
                                              out.data_ptr()) == -1
    assert host.shimmer_chase_pairs_host(2, *p, 128, out.data_ptr()) == -1


# --- the wrappers on a machine without a card ---


def test_entry_point_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        eg.main(device=None)


@pytest.mark.parametrize("kind", ["gather", "gather_cols", "gather_sum", "chase_f32",
                                  "chase_bf16", "gather_col_sum"])
def test_cpu_tensors_take_the_plain_version(kind):
    g.reset_launches()
    tab, idx = table_and_indices(5, 128, finite=kind.endswith("sum"))
    if kind == "gather":
        got, want = g.row_gather(tab, idx), g.row_gather_plain(tab, idx)
    elif kind == "gather_cols":
        t = tab.T.contiguous()
        got, want = g.row_gather_cols(t, idx), g.row_gather_cols_plain(t, idx)
    elif kind == "gather_sum":
        got, want = g.row_gather_sum(tab, idx), g.row_gather_sum_plain(tab, idx)
    elif kind == "gather_col_sum":
        got, want = g.row_gather_col_sum(tab, idx, 1, 4), g.row_gather_col_sum_plain(tab, idx, 1, 4)
        assert got.shape == () and got.dtype == torch.float32
    else:
        t = tab.to(torch.bfloat16) if kind == "chase_bf16" else tab
        got, want = g.row_chase(t, idx, 8), g.row_chase_plain(t, idx, 8)
    assert bits_equal(got, want)
    assert g.launch_counts() == dict.fromkeys(eg.KERNELS, 0)


@pytest.mark.parametrize(
    "case",
    ["table_f64", "idx_i64", "table_1d", "idx_2d", "table_strided", "idx_strided",
     "gather_width_6", "sum_width_132", "chase_width_12", "chase_f16", "empty_table",
     "meta_device", "cols_idx_2d", "col_sum_col_128", "col_sum_col_negative",
     "col_sum_repeats_negative", "col_sum_repeats_past_2_24", "col_sum_idx_i64"],
)
def test_wrappers_reject_bad_arguments(case):
    tab, idx = table_and_indices(6, 128)
    err = ValueError
    if case == "table_f64":
        fn, args, err = g.row_gather, (tab.double(), idx), TypeError
    elif case == "idx_i64":
        fn, args, err = g.row_chase, (tab, idx.long(), 4), TypeError
    elif case == "table_1d":
        fn, args = g.row_gather_sum, (tab[0].contiguous(), idx)
    elif case == "idx_2d":
        fn, args = g.row_gather, (tab, idx.view(-1, 8))
    elif case == "table_strided":
        fn, args = g.row_gather, (tab[:, ::2], idx)
    elif case == "idx_strided":
        fn, args = g.row_chase, (tab, idx[::2], 4)
    elif case == "gather_width_6":
        fn, args = g.row_gather, (tab[:, :6].contiguous(), idx)
    elif case == "sum_width_132":
        fn, args = g.row_gather_sum, (torch.zeros(R, 132), idx)
    elif case == "chase_width_12":
        fn, args = g.row_chase, (tab[:, :12].contiguous(), idx, 4)
    elif case == "chase_f16":
        fn, args, err = g.row_chase, (tab.half(), idx, 4), TypeError
    elif case == "empty_table":
        fn, args = g.row_gather, (torch.zeros(0, 128), idx)
    elif case == "cols_idx_2d":
        fn, args = g.row_gather_cols, (tab.T.contiguous(), idx.view(-1, 8))
    elif case == "col_sum_col_128":
        fn, args = g.row_gather_col_sum, (tab, idx, 128, 4)
    elif case == "col_sum_col_negative":
        fn, args = g.row_gather_col_sum, (tab, idx, -1, 4)
    elif case == "col_sum_repeats_negative":
        fn, args = g.row_gather_col_sum, (tab, idx, 1, -1)
    elif case == "col_sum_repeats_past_2_24":
        fn, args = g.row_gather_col_sum, (tab, idx, 1, g.COL_SUM_MAX_REPEATS + 1)
    elif case == "col_sum_idx_i64":
        fn, args, err = g.row_gather_col_sum, (tab, idx.long(), 1, 4), TypeError
    else:
        fn, args = g.row_gather, (tab.to("meta"), idx.to("meta"))
    with pytest.raises(err):
        fn(*args)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(cuda_build.KernelBuildError, match="nvcc"):
        cuda_build.build(force=True)


def test_load_host_builds_the_bodies_the_card_is_held_to(host, tmp_path, monkeypatch):
    """cuda_build.load_host, which tests/test_torch_gather_card.py holds the
    card's gather-sums to, builds the same host bodies as this file's build: the same bounds
    and the same bits on a case of each sum."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the host build of the kernel bodies needs it")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    lib = cuda_build.load_host("gather")
    assert (tmp_path / "libshimmer_gather_host.so").is_file()
    for name in ("shimmer_gather_sum_warps", "shimmer_gather_sum_rows_per_warp", *SUM_BOUNDS):
        assert getattr(lib, name)() == getattr(host, name)()
    p, ci = ctypes.c_void_p, ctypes.c_int
    lib.shimmer_row_gather_sum_host.argtypes = [p, ci, ci, p, ci, p]
    lib.shimmer_row_gather_col_sum_host.argtypes = [p, ci, ci, p, ci, ci, ci, p]
    tab, idx = sum_indices(1000, 128)
    got, want = torch.empty(128), torch.empty(128)
    for fn, out in ((lib.shimmer_row_gather_sum_host, got), (host.shimmer_row_gather_sum_host, want)):
        call(fn, tab.data_ptr(), R, 128, idx.data_ptr(), 1000, out.data_ptr())
    assert bits_equal(got, want)
    got, want = torch.empty(()), torch.empty(())
    for fn, out in ((lib.shimmer_row_gather_col_sum_host, got),
                    (host.shimmer_row_gather_col_sum_host, want)):
        call(fn, tab.data_ptr(), R, 128, idx.data_ptr(), 1000, 1, 4, out.data_ptr())
    assert bits_equal(got.reshape(1), want.reshape(1))


def test_every_library_source_is_in_the_checkout():
    for source, headers in cuda_build.LIBRARIES.values():
        for f in (source, *headers):
            assert (CSRC / f).is_file(), f
