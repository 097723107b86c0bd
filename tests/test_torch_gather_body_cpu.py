"""The gather kernels' own bodies (csrc/gather_body.cuh), compiled for the
host with g++ (csrc/gather_host.cpp), against the port's plain torch
versions (ops/gather.py); and the wrappers' contract on a machine without
a card.

The gathers and the chases are bit-equal: they move values or add them
in the same order (row[1..8] left to right, then into the accumulator),
and g++ builds without FMA contraction.  The gather-sum is bit-equal to a
numpy sum in the kernel's own order (chunks of rows per warp, warps in
order within a block, blocks in order), and within the entry point's
SUM_RTOL of the plain version, which sums in torch's order.  Every body
reads a row of zeros for an index outside [0, R), as the plain versions
do, including indices that bf16 rounding pushes to R.
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
    lib.shimmer_row_chase_host.argtypes = [ci, p, ci, ci, p, ci, ci, p]
    lib.shimmer_row_chase_host.restype = ci
    for name in ("shimmer_gather_sum_rows_per_warp", "shimmer_gather_sum_warps",
                 "shimmer_gather_sum_max_width", "shimmer_gather_cols_stage_max_rows"):
        getattr(lib, name).restype = ci
    assert lib.shimmer_gather_sum_max_width() == g.SUM_MAX_WIDTH
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


def sum_in_kernel_order(tab, idx, rows_per_warp, warps):
    """numpy float32 sum in the kernel's order: rows left to right within
    a warp's chunk, the chunk sums in warp order, the blocks in order."""
    rows = g.row_gather_plain(tab, idx).numpy()
    n, width = rows.shape
    total = np.zeros(width, np.float32)
    n_blocks = -(-n // (rows_per_warp * warps))
    for b in range(n_blocks):
        block = None
        for w in range(warps):
            c = b * warps + w
            s = np.zeros(width, np.float32)
            for i in range(min(n, c * rows_per_warp), min(n, (c + 1) * rows_per_warp)):
                s = s + rows[i]
            block = s if block is None else block + s
        total = total + block
    return total


@pytest.mark.parametrize("n", [1, 64, 1000, 1536])
@pytest.mark.parametrize("width", [8, 128])
def test_gather_sum_body_in_its_order(host, width, n):
    tab, idx = table_and_indices(3, width, n=max(n, 8), finite=True)
    idx = idx[:n].contiguous()
    out = torch.empty(width)
    call(host.shimmer_row_gather_sum_host, tab.data_ptr(), R, width, idx.data_ptr(), n,
         out.data_ptr())
    want = sum_in_kernel_order(tab, idx, host.shimmer_gather_sum_rows_per_warp(),
                               host.shimmer_gather_sum_warps())
    np.testing.assert_array_equal(out.numpy(), want)
    plain = g.row_gather_sum_plain(tab, idx)
    scale = g.row_gather_plain(tab, idx).abs().sum(0)
    assert bool(((out - plain).abs() <= eg.SUM_RTOL * scale).all())


def test_host_body_rejects_what_the_kernels_do_not_take(host):
    tab, idx = table_and_indices(4, 128)
    out = torch.empty(N * 128)
    p = (tab.data_ptr(), R)
    assert host.shimmer_row_gather_host(*p, 6, idx.data_ptr(), N, out.data_ptr()) == -1
    assert host.shimmer_row_gather_sum_host(*p, 132, idx.data_ptr(), N, out.data_ptr()) == -1
    assert host.shimmer_row_chase_host(0, *p, 12, idx.data_ptr(), N, 4, out.data_ptr()) == -1
    assert host.shimmer_row_chase_host(2, *p, 128, idx.data_ptr(), N, 4, out.data_ptr()) == -1


# --- the wrappers on a machine without a card ---


def test_entry_point_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        eg.main(device=None)


@pytest.mark.parametrize("kind", ["gather", "gather_cols", "gather_sum", "chase_f32",
                                  "chase_bf16"])
def test_cpu_tensors_take_the_plain_version(kind):
    g.reset_launches()
    tab, idx = table_and_indices(5, 128, finite=kind == "gather_sum")
    if kind == "gather":
        got, want = g.row_gather(tab, idx), g.row_gather_plain(tab, idx)
    elif kind == "gather_cols":
        t = tab.T.contiguous()
        got, want = g.row_gather_cols(t, idx), g.row_gather_cols_plain(t, idx)
    elif kind == "gather_sum":
        got, want = g.row_gather_sum(tab, idx), g.row_gather_sum_plain(tab, idx)
    else:
        t = tab.to(torch.bfloat16) if kind == "chase_bf16" else tab
        got, want = g.row_chase(t, idx, 8), g.row_chase_plain(t, idx, 8)
    assert bits_equal(got, want)
    assert g.launch_counts() == dict.fromkeys(eg.KERNELS, 0)


@pytest.mark.parametrize(
    "case",
    ["table_f64", "idx_i64", "table_1d", "idx_2d", "table_strided", "idx_strided",
     "gather_width_6", "sum_width_132", "chase_width_12", "chase_f16", "empty_table",
     "meta_device", "cols_idx_2d"],
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
    else:
        fn, args = g.row_gather, (tab.to("meta"), idx.to("meta"))
    with pytest.raises(err):
        fn(*args)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(cuda_build.KernelBuildError, match="nvcc"):
        cuda_build.build(force=True)


def test_every_library_source_is_in_the_checkout():
    for source, headers in cuda_build.LIBRARIES.values():
        for f in (source, *headers):
            assert (CSRC / f).is_file(), f
