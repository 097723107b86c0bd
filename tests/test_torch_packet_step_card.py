"""The packet-step kernels (csrc/packet_step.cu) on the card, through every
case of their entry point (``experiments/packet_step.py``) at the
reference scripts' sizes, row 15 over the bench scene's BVH8:

* each case at every step count against its plain version on the same
  tensors, bit for bit (row 15: the output and the carried stacks), its
  kernel and its chain alone's launched beside the timed launches;
* row 15 and its chain alone, every variant, from a patterned stack
  (``measure.patterned_stack``) in place of interpret mode's INT32_MIN,
  against the plain versions, its pops and pushes landed;
* row 16's chains: the distinct rows are the tail and the cycle.

Marked ``card``; run on the card as tests/card_checks.py says.
"""

import pytest
import torch

from card_checks import card  # noqa: F401  (a fixture)
from shimmer_tpu_torch.bench_scene import BENCH_TRIS, build_bench_scene
from shimmer_tpu_torch.experiments import packet_step as eps
from shimmer_tpu_torch.measure import patterned_stack
from shimmer_tpu_torch.ops import packet_step as pk

pytestmark = pytest.mark.card

CASES = {case.name: case for case in eps.cases()}


@pytest.fixture(scope="module")
def tables(card):
    tris = build_bench_scene(BENCH_TRIS, device="cpu")[0].triangles
    return tris.rows8.to(card), tris.meta.to(card), tris.stack_depth


@pytest.mark.parametrize("name", list(CASES))
def test_case_equals_its_plain_version(tables, name):
    case = CASES[name]
    before = pk.launch_counts()
    res = eps.run_case(case, eps.make_inputs(case, tables[0].device, tables))
    launched = {k: v - before[k] for k, v in pk.launch_counts().items()}
    assert res["ok"], f"max |d| {res['max_abs_err']}"
    # The cases count their timed launches, not the ones compared with the
    # plain version.
    assert launched[case.kernel] > res["launches"]
    chain = res.get("chain_kernel")
    if chain is not None and chain != case.kernel:
        assert launched[chain] > res["chain_launches"]
    if case.kernel == "step_ablate":
        for steps, p in res["steps"].items():
            assert p["distinct"] == p["mu"] + p["lam"] <= steps, p


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c.kernel == "step_attrib"])
def test_step_attribution_from_a_patterned_stack(tables, name):
    case = CASES[name]
    x = eps.make_inputs(case, tables[0].device, tables)
    size, n_rows, k = x["stack_size"], x["meta"].shape[0], eps.ATTRIB_PACKETS
    init = patterned_stack(n_rows, k, size, eps.SEED + 1).to(tables[0].device)
    args = (x["rows8"], x["meta"], x["rays"], case.variant, case.steps[-1], k, size, init)
    got, got_st = pk.step_attrib(*args)
    want, want_st = pk.step_attrib_plain(*args)
    assert torch.equal(got, want) and torch.equal(got_st, want_st)
    chain_want = pk.step_attrib_chain_plain(x["meta"], case.variant, case.programs, k,
                                            case.steps[-1], size, init)
    assert torch.equal(pk.step_attrib_chain(*args), chain_want)
    if case.variant != "noscalar":
        assert not torch.equal(got_st[:, 1:3], init[:, 1:3]), "no pop or push landed"
