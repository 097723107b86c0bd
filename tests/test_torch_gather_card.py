"""The row-gather kernels (csrc/gather.cu) on the card, through every case of
their entry point (``experiments/gather.py``) at the reference scripts'
sizes, each against its plain version on the same tensors:

* gathers and chases bit for bit, gather-sums within ``SUM_RTOL``, each
  case's kernels launched;
* each chase and gather-sum in the form its rule names
  (``ops.gather.chase_staged``, ``gather_sum_counted``), and the rules
  naming the set their timings chose;
* each gather-sum launched twice with the same bits, and equal to the host
  build of its body (csrc/gather_host.cpp, g++ without FMA contraction);
* a bf16 chase lane that meets an index rounded out of range, the
  per-lane chase one row past the staged form's table limit, and
  ``index_select`` equal to the row gathers.

Marked ``card``; run on the card as tests/card_checks.py says.
"""

import ctypes

import numpy as np
import pytest
import torch

from card_checks import card  # noqa: F401  (a fixture)
from shimmer_tpu_torch.experiments import gather as eg
from shimmer_tpu_torch.ops import cuda_build
from shimmer_tpu_torch.ops import gather as gk

pytestmark = pytest.mark.card

CASES = {case.name: case for case in eg.cases()}
# The per-lane chase beyond the staged form's table limit: R, N, K.
PER_LANE_CASE = (gk.STAGE_MAX_ROWS + 1, 4096, 32)


def staged_by_measurement(res: dict) -> bool:
    """The chases the card runs staged (set by timing every chase case in
    each form, PERF.md): all but 6C's at N = 8,192."""
    return res["kernel"].startswith("row_chase") and not (res["row"] == "6C" and res["N"] == 8192)


def counted_by_measurement(res: dict) -> bool:
    """The gather-sums the card runs counted (set by timing both forms over
    a grid of sizes, PERF.md): row 9 at N = 131,072."""
    return res["kernel"] == "row_gather_sum" and res["N"] == 131072


@pytest.fixture(scope="module")
def rows(card):
    """Every case of the entry point on the card: its result and the
    kernels it launched."""
    out = {}
    for name, case in CASES.items():
        before = gk.launch_counts()
        res = eg.run_case(case, *eg.make_inputs(case, card))
        torch.cuda.synchronize()
        out[name] = res, {k: v - before[k] for k, v in gk.launch_counts().items() if v > before[k]}
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_case_equals_its_plain_version(rows, name):
    res, launched = rows[name]
    assert res["ok"], f"max |d| {res['max_abs_err']}"
    for kernel in res["kernels"] + ((res["chain_kernel"],) if "chain_kernel" in res else ()):
        assert kernel in launched, kernel
    if "repeat_equal" in res:
        assert res["repeat_equal"]


def test_each_chase_and_gather_sum_runs_in_the_form_its_rule_names(rows):
    results = [res for res, _ in rows.values()]
    for res in results:
        if "staged" in res:
            assert res["ran_staged"] == res["staged"], res["name"]
        if "counted" in res:
            assert res["ran_counted"] == res["counted"], res["name"]
    assert ([r["name"] for r in results if r.get("staged")]
            == [r["name"] for r in results if staged_by_measurement(r)])
    assert ([r["name"] for r in results if r.get("counted")]
            == [r["name"] for r in results if counted_by_measurement(r)])


def test_a_bf16_chase_lane_meets_an_index_rounded_out_of_range(rows):
    assert sum(res["oob_lanes"] for res, _ in rows.values()
               if res["kernel"] == "row_chase_bf16") > 0


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if c.kernel in ("row_gather", "row_gather_cols")])
def test_index_select_equals_the_row_gather(card, name):
    case = CASES[name]
    table, idx = eg.make_inputs(case, card)
    if case.kernel == "row_gather_cols":
        assert torch.equal(torch.index_select(table, 1, idx), gk.row_gather_cols(table, idx))
    else:
        assert torch.equal(torch.index_select(table, 0, idx), gk.row_gather(table, idx))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_per_lane_chase_beyond_the_staged_limit(card, dtype):
    n_rows, n, steps = PER_LANE_CASE
    rng = np.random.default_rng([eg.SEED, n_rows, n])
    table = rng.standard_normal((n_rows, 128)).astype(np.float32)
    table[:, 0] = rng.integers(0, n_rows, n_rows)
    idx = torch.from_numpy(rng.integers(0, n_rows, n).astype(np.int32)).to(card)
    t = torch.from_numpy(table).to(card).to(dtype)
    assert not gk.chase_staged(n_rows, n, steps)
    before = gk.launch_counts()["row_chase_staged"]
    got = gk.row_chase(t, idx, steps)
    assert gk.launch_counts()["row_chase_staged"] == before
    assert torch.equal(got, gk.row_chase_plain(t, idx, steps))


# Each gather-sum case of the entry point, and the one-column sum at its
# floor's N: (case, the indices taken, the column arguments).
GATHER_SUMS = [pytest.param(case, None, (), id=name) for name, case in CASES.items()
               if case.kernel == "row_gather_sum"] + [
    pytest.param(case, n, (eg.COL_SUM_COL, case.steps), id=f"{name} first {n or case.n}")
    for name, case in CASES.items() if case.kernel == "row_gather_col_sum"
    for n in (None, eg.FLOOR_N)]


@pytest.fixture(scope="module")
def host(card):
    lib = cuda_build.load_host("gather")
    p, ci = ctypes.c_void_p, ctypes.c_int
    lib.shimmer_row_gather_sum_host.argtypes = [p, ci, ci, p, ci, p]
    lib.shimmer_row_gather_col_sum_host.argtypes = [p, ci, ci, p, ci, ci, ci, p]
    return lib


@pytest.mark.parametrize("case, n, col", GATHER_SUMS)
def test_gather_sum_equals_its_host_build(card, host, case, n, col):
    """The card's sum, launched twice, and the host build of the kernels'
    bodies on the same inputs copied to the CPU: the same bits."""
    table, idx = eg.make_inputs(case, card)
    idx = idx[:n]

    def on_card():
        return (gk.row_gather_col_sum(table, idx, *col) if col
                else gk.row_gather_sum(table, idx)).cpu().view(torch.int32)

    first, second = on_card(), on_card()
    tc, ic = table.cpu(), idx.cpu()
    want = torch.empty(() if col else tc.shape[1])
    fn = host.shimmer_row_gather_col_sum_host if col else host.shimmer_row_gather_sum_host
    assert fn(tc.data_ptr(), tc.shape[0], tc.shape[1], ic.data_ptr(), ic.shape[0], *col,
              want.data_ptr()) == 0, "the host build refused the case"
    assert torch.equal(first, second)
    assert torch.equal(first, want.view(torch.int32))
