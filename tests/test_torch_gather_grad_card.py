"""The small-table gather's backward on the card (``ops.gather.gather_rows``,
its kernel ``row_scatter_add`` in csrc/gather.cu), each case against torch's
own on the same tensors:

* ``row_scatter_add`` ``torch.equal`` to ``torch.zeros(M, C).index_put_(
  (idx,), g, accumulate=True)`` on the card and to float32 adds in lane
  order on the host (``np.add.at``), for M in {1, 3, 32}, C in {2, 3, 4,
  32} and N in {1, 1,000, 131,072, 2^20} lanes; one launch a call;
* the gradient of ``ops.math.take_clamped`` (ids of -1 clamped into the
  table, as a material-less lane's) ``torch.equal`` to plain indexing's,
  with one row holding 97% of the lanes, with an expanded gradient and with
  ids of two dimensions; each backward one launch, counted under
  ``Gather/Backward kernel``;
* the tables the kernel leaves to aten (one column, 33 rows, float64):
  no launch, the reason counted, the gradient plain indexing's.

Marked ``card``; run on the card as tests/card_checks.py says.
"""

import numpy as np
import pytest
import torch

from card_checks import card  # noqa: F401  (a fixture)
from shimmer_tpu_torch.ops import gather as gk
from shimmer_tpu_torch.ops import math as om
from shimmer_tpu_torch.utils import stats

pytestmark = pytest.mark.card

ROWS, WIDTHS, LANES = (1, 3, 32), (2, 3, 4, 32), (1, 1000, 131072, 1 << 20)
# The material table of the gradient cell: three rows of three coefficients.
CELL_ROWS, CELL_WIDTH, CELL_LANES = 3, 3, 131072


def scatter_inputs(m: int, c: int, n: int, seed: int, hot_share: float = 0.0):
    """(ids, grad) as numpy: ids uniform over [0, m), then ``hot_share`` of
    the lanes sent to row 0."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, m, n)
    ids = np.where(rng.random(n) < hot_share, 0, ids)
    return ids, rng.standard_normal((n, c)).astype(np.float32)


def lane_order(grad: np.ndarray, ids: np.ndarray, m: int) -> np.ndarray:
    """Each row's lanes added from 0 one at a time in lane order, in float32."""
    out = np.zeros((m, grad.shape[1]), np.float32)
    for col in range(grad.shape[1]):
        np.add.at(out[:, col], ids, grad[:, col])
    return out


def scatter_launches() -> int:
    return gk.row_scatter_add.launches["row_scatter_add"]


@pytest.mark.parametrize("n", LANES)
@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("m", ROWS)
def test_scatter_add_equals_torchs_index_put(card, m, c, n):
    ids, grad = scatter_inputs(m, c, n, seed=m * 1000 + c * 10 + n % 7)
    idx, g = torch.from_numpy(ids).to(card), torch.from_numpy(grad).to(card)
    before = scatter_launches()
    got = gk.row_scatter_add(g, idx, m)
    assert scatter_launches() == before + 1
    want = torch.zeros(m, c, device=card).index_put_((idx,), g, accumulate=True)
    assert torch.equal(got, want)
    assert np.array_equal(got.cpu().numpy(), lane_order(grad, ids, m))


def test_scatter_add_of_no_lanes_is_zero(card):
    g = torch.empty(0, 3, device=card)
    got = gk.row_scatter_add(g, torch.empty(0, dtype=torch.int64, device=card), 3)
    assert torch.equal(got, torch.zeros(3, 3, device=card))


def _ids_and_grad(case: str, dev):
    """A case's (ids before clamping, grad_out) at the cell's table shape."""
    ids, grad = scatter_inputs(CELL_ROWS, CELL_WIDTH, CELL_LANES, seed=7,
                               hot_share=0.97 if case == "one_row_97pct" else 0.0)
    if case == "clamped_minus_one":
        ids = np.where(np.random.default_rng(8).random(CELL_LANES) < 0.4, -1, ids)
    ids = torch.from_numpy(ids).to(dev)
    g = torch.from_numpy(grad).to(dev)
    if case == "expanded_grad":
        g = g[:1].expand(CELL_LANES, CELL_WIDTH)
    if case == "two_dim_ids":
        ids, g = ids.reshape(-1, 2), g.reshape(-1, 2, CELL_WIDTH)
    return ids, g


@pytest.mark.parametrize("case", ["uniform", "one_row_97pct", "clamped_minus_one",
                                  "expanded_grad", "two_dim_ids"])
def test_gather_gradient_equals_plain_indexing(card, case):
    ids, g = _ids_and_grad(case, card)
    table = torch.rand(CELL_ROWS, CELL_WIDTH, device=card, requires_grad=True)
    stats.clear()
    before = scatter_launches()
    out = om.take_clamped(table, ids)
    (got,) = torch.autograd.grad(out, table, g)
    assert scatter_launches() == before + 1
    counted = {k: v for k, v in stats.as_dict().items() if k.startswith("Gather/")}
    assert counted == {gk.BACKWARD_KERNEL: 1.0}
    plain = table[torch.clamp(ids, 0, CELL_ROWS - 1)]
    assert torch.equal(out, plain)
    (want,) = torch.autograd.grad(plain, table, g)
    assert torch.equal(got, want)
    stats.clear()


@pytest.mark.parametrize("shape, dtype, reason", [
    ((3, 1), torch.float32, "columns"),
    ((3,), torch.float32, "columns"),
    ((33, 3), torch.float32, "rows"),
    ((3, 3), torch.float64, "dtype"),
])
def test_tables_left_to_aten(card, shape, dtype, reason):
    idx = torch.randint(-1, shape[0], (4096,), device=card)
    table = torch.rand(shape, dtype=dtype, device=card, requires_grad=True)
    stats.clear()
    before = scatter_launches()
    out = om.small_gather(table, idx)
    g = torch.rand(out.shape, dtype=dtype, device=card)
    (got,) = torch.autograd.grad(out, table, g)
    assert scatter_launches() == before
    counted = {k: v for k, v in stats.as_dict().items() if k.startswith("Gather/")}
    assert counted == {f"{gk.BACKWARD_ATEN}: {reason}": 1.0}
    k = shape[0]
    safe = torch.clamp(torch.where(idx < 0, idx + k, idx) if k > om.SMALL_GATHER_ROWS else idx,
                       0, k - 1)
    (want,) = torch.autograd.grad(table[safe], table, g)
    assert torch.equal(got, want)
    stats.clear()
