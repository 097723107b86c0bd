"""The small-table gather's backward on the CPU (``ops.gather.gather_rows``,
``backward_reason``, ``row_scatter_add`` and its plain version): the rule
that picks the kernel by device, shape, dtype and lanes, the registry's
counts under grad, and gradients ``torch.equal`` to plain indexing's.  The
kernel itself runs in tests/test_torch_gather_grad_card.py."""

import numpy as np
import pytest
import torch

from shimmer_tpu_torch.ops import gather as gk
from shimmer_tpu_torch.ops import math as om
from shimmer_tpu_torch.utils import stats

F32, F64 = torch.float32, torch.float64


@pytest.mark.parametrize("device_type, dtype, shape, lanes, reason", [
    ("cuda", F32, (3, 3), 131072, None),
    ("cuda", F32, (1, 2), 1, None),
    ("cuda", F32, (32, 32), 2**31 - 1, None),
    ("cuda", F32, (3, 3), 0, None),
    ("cpu", F32, (3, 3), 131072, "cpu"),
    ("cpu", F32, (3, 1), 10, "cpu"),
    ("cuda", F32, (3, 1), 10, "columns"),
    ("cuda", F32, (3,), 10, "columns"),
    ("cuda", F32, (3, 33), 10, "columns"),
    ("cuda", F32, (3, 4, 4), 10, "columns"),
    ("cuda", F32, (33, 3), 10, "rows"),
    ("cuda", F64, (3, 3), 10, "dtype"),
    ("cuda", torch.bfloat16, (3, 3), 10, "dtype"),
    ("cuda", F32, (3, 3), 2**31, "lanes"),
])
def test_backward_reason(device_type, dtype, shape, lanes, reason):
    assert gk.backward_reason(device_type, dtype, torch.Size(shape), lanes) == reason


def test_the_kernels_tables_are_the_small_gathers():
    assert gk.SCATTER_MAX_ROWS == om.SMALL_GATHER_ROWS


def _gather_counts() -> dict:
    return {k: v for k, v in stats.as_dict().items() if k.startswith("Gather/")}


def test_gather_rows_under_grad_on_the_cpu_keeps_atens_backward_and_counts_it():
    table = torch.rand(3, 3, requires_grad=True)
    idx = torch.randint(0, 3, (1000,))
    stats.clear()
    try:
        out = gk.gather_rows(table, idx)
        assert _gather_counts() == {f"{gk.BACKWARD_ATEN}: cpu": 1.0}
        assert type(out.grad_fn).__name__ == "IndexBackward0"
        assert torch.equal(out, table[idx])
    finally:
        stats.clear()


@pytest.mark.parametrize("grad_mode, requires_grad", [(False, True), (True, False), (False, False)])
def test_gather_rows_without_grad_is_plain_indexing_and_counts_nothing(grad_mode, requires_grad):
    table = torch.rand(3, 3, requires_grad=requires_grad)
    idx = torch.randint(0, 3, (100,))
    stats.clear()
    try:
        with torch.set_grad_enabled(grad_mode):
            out = gk.gather_rows(table, idx)
        assert _gather_counts() == {}
        assert out.grad_fn is None
        assert torch.equal(out, table.detach()[idx])
    finally:
        stats.clear()


def _ids_and_grad(case: str, n: int = 4096, rows: int = 3, width: int = 3):
    """A case's (ids before clamping, grad_out)."""
    rng = np.random.default_rng(3)
    ids = rng.integers(0, rows, n)
    if case == "one_row_97pct":
        ids = np.where(rng.random(n) < 0.97, 0, ids)
    if case == "clamped_minus_one":
        ids = np.where(rng.random(n) < 0.4, -1, ids)
    g = torch.from_numpy(rng.standard_normal((n, width)).astype(np.float32))
    ids = torch.from_numpy(ids)
    if case == "expanded_grad":
        g = g[:1].expand(n, width)
    if case == "two_dim_ids":
        ids, g = ids.reshape(-1, 2), g.reshape(-1, 2, width)
    return ids, g


CASES = ["uniform", "one_row_97pct", "clamped_minus_one", "expanded_grad", "two_dim_ids"]


@pytest.mark.parametrize("case", CASES)
def test_the_functions_gradient_equals_plain_indexings(case, monkeypatch):
    """With the rule made to allow it on the CPU, ``take_clamped`` runs the
    Function, whose backward there is the plain version (counted as
    aten's)."""
    monkeypatch.setattr(gk, "backward_reason", lambda *args: None)
    ids, g = _ids_and_grad(case)
    table = torch.rand(3, 3, requires_grad=True)
    stats.clear()
    try:
        out = om.take_clamped(table, ids)
        assert type(out.grad_fn).__name__ == "_GatherRowsBackward"
        (got,) = torch.autograd.grad(out, table, g)
        assert _gather_counts() == {f"{gk.BACKWARD_ATEN}: cpu": 1.0}
    finally:
        stats.clear()
    plain = table[torch.clamp(ids, 0, 2)]
    assert torch.equal(out, plain)
    (want,) = torch.autograd.grad(plain, table, g)
    assert torch.equal(got, want)


@pytest.mark.parametrize("gather, rows", [(om.take_clamped, 3), (om.take_wrapped, 3),
                                          (om.small_gather, 3), (om.small_gather, 40)])
def test_the_port_s_gathers_go_through_gather_rows(gather, rows, monkeypatch):
    seen = []

    def spy(table, idx):
        seen.append((table.shape, idx.dtype))
        return table[idx]

    monkeypatch.setattr(om, "gather_rows", spy)
    table = torch.rand(rows, 3, requires_grad=True)
    ids = torch.tensor([-1, 0, 2, rows - 1, rows + 5], dtype=torch.int32)
    out = gather(table, ids)
    assert seen == [(table.shape, torch.int64)]
    assert out.shape == (5, 3)


def _lane_order(grad: np.ndarray, ids: np.ndarray, rows: int) -> np.ndarray:
    """Each row's lanes added from 0 one at a time in lane order, in float32."""
    out = np.zeros((rows, grad.shape[1]), np.float32)
    for col in range(grad.shape[1]):
        np.add.at(out[:, col], ids, grad[:, col])
    return out


@pytest.mark.parametrize("n", [1, 1000, 4096])
@pytest.mark.parametrize("rows, width", [(1, 2), (3, 3), (32, 4), (5, 7)])
def test_plain_scatter_add_is_index_put_in_lane_order(rows, width, n):
    """``row_scatter_add`` on the CPU adds each row's lanes from 0 one at a
    time in lane order, as the kernel does on the card, and as the CPU's
    ``index_put_(accumulate=True)`` does at these sizes (at most 28,672
    values, below its threads' grain of 32,768)."""
    rng = np.random.default_rng(rows * 100 + width)
    ids = rng.integers(0, rows, n)
    grad = rng.standard_normal((n, width)).astype(np.float32)
    g, idx = torch.from_numpy(grad), torch.from_numpy(ids)
    got = gk.row_scatter_add(g, idx, rows)
    assert torch.equal(got, torch.zeros(rows, width).index_put_((idx,), g, accumulate=True))
    assert np.array_equal(got.numpy(), _lane_order(grad, ids, rows))
    serial = np.zeros((rows, width), np.float32)
    for i in range(min(n, 1000)):
        serial[ids[i]] = serial[ids[i]] + grad[i]
    assert np.array_equal(gk.row_scatter_add(g[:1000], idx[:1000], rows).numpy(), serial)


@pytest.mark.parametrize("rows, width", [(3, 3), (32, 32)])
def test_plain_scatter_add_at_the_cells_lanes_is_deterministic_index_put(rows, width):
    """At 131,072 lanes the CPU's default ``index_put_`` adds with threads;
    in its deterministic mode it adds in lane order, as the plain version
    and the kernel do."""
    rng = np.random.default_rng(11)
    ids = rng.integers(0, rows, 131072)
    ids = np.where(rng.random(131072) < 0.6, 0, ids)
    grad = rng.standard_normal((131072, width)).astype(np.float32)
    g, idx = torch.from_numpy(grad), torch.from_numpy(ids)
    got = gk.row_scatter_add(g, idx, rows)
    assert np.array_equal(got.numpy(), _lane_order(grad, ids, rows))
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        want = torch.zeros(rows, width).index_put_((idx,), g, accumulate=True)
    finally:
        torch.use_deterministic_algorithms(deterministic)
    assert torch.equal(got, want)


@pytest.mark.parametrize("grad, idx, rows, error", [
    (torch.zeros(4, 3), torch.zeros(4, 1, dtype=torch.int64), 3, ValueError),
    (torch.zeros(4, 3), torch.zeros(5, dtype=torch.int64), 3, ValueError),
    (torch.zeros(4, 3, dtype=F64), torch.zeros(4, dtype=torch.int64), 3, TypeError),
    (torch.zeros(4, 3), torch.zeros(4, dtype=torch.int32), 3, TypeError),
    (torch.zeros(4, 3).t(), torch.zeros(3, dtype=torch.int64), 3, ValueError),
    (torch.zeros(4, 3), torch.zeros(4, dtype=torch.int64), 0, ValueError),
    (torch.zeros(4, 3), torch.zeros(4, dtype=torch.int64), 33, ValueError),
    (torch.zeros(4, 1), torch.zeros(4, dtype=torch.int64), 3, ValueError),
    (torch.zeros(4, 33), torch.zeros(4, dtype=torch.int64), 3, ValueError),
])
def test_scatter_add_refuses_what_the_kernel_does_not_take(grad, idx, rows, error):
    with pytest.raises(error):
        gk.row_scatter_add(grad, idx, rows)
