"""The packet-step kernels' own bodies (csrc/packet_step_body.cuh), compiled
for the host with g++ (csrc/packet_step_host.cpp), against the port's
plain torch versions (ops/packet_step.py); and the wrappers' contract on a
machine without a card.

Everything is bit-equal: the slab chases count whole hits, the chains
move integers, and the float sums, the step attribution's slab and
watertight tests and the ablation's hi|lo slab run in the same operation
order on both sides, with g++ building without FMA contraction.  The
step attribution's carried stacks are equal too.  The split form of the
slab chase (the chain walk, then per-lane integer counts over the slab
pass's chunks of steps) equals both the plain version and the per-lane
body it replaces on the card.  The step attribution runs as the card
runs it (each program's packet on its own, its visits from the stack's
slot 1 in closed form, the lanes' OR of hit bits taken after the steps),
and the closed form of slot 1 equals the pops it stands for.  The step
ablation runs as the card runs it too: its next table (each row's next row,
the lanes' OR of hits included), the walk to the chain's first repeated
row, and the sums of the visited rows' terms in step order, each held
against the plain versions.
"""

import ctypes
import dataclasses
import shutil
import subprocess

import numpy as np
import pytest
import torch

from shimmer_tpu_torch import bench_scene
from shimmer_tpu_torch.experiments import packet_step as eps
from shimmer_tpu_torch.ops import packet_step as ps
from shimmer_tpu_torch.ops.cuda_build import CSRC, LIBRARIES

torch.set_num_threads(1)

R, P = 512, 128


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host build of the kernel bodies needs it")
    out = tmp_path_factory.mktemp("packet_step_host") / "libpacket_step_host.so"
    subprocess.run(
        [gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
         "-I", str(CSRC), str(CSRC / "packet_step_host.cpp"), "-o", str(out)],
        check=True, capture_output=True, timeout=300,
    )
    lib = ctypes.CDLL(str(out))
    p, ci = ctypes.c_void_p, ctypes.c_int
    lib.shimmer_packet_slab_chase_host.argtypes = [ci, ci, p, ci, p, p, ci, p]
    lib.shimmer_packet_slab_chase_split_host.argtypes = [ci, ci, p, ci, p, p, ci, ci, p]
    lib.shimmer_step_attrib_packet_host.argtypes = [ci, p, p, ci, p, ci, ci, ci, ci, p, p]
    lib.shimmer_step_attrib_chain_host.argtypes = [ci, p, ci, ci, ci, ci, ci, p, p]
    lib.shimmer_attrib_slot1_mismatches.argtypes = [p, ci, ci]
    lib.shimmer_attrib_slot1_mismatches.restype = ctypes.c_longlong
    lib.shimmer_step_ablate_host.argtypes = [ci, p, p, p, ci, ci, ci, ci, p]
    lib.shimmer_ablate_next_host.argtypes = [ci, p, p, p, ci, p]
    lib.shimmer_ablate_walk_host.argtypes = [p, ci, ci, p, p]
    lib.shimmer_ablate_ones_mismatches.argtypes = [ci]
    lib.shimmer_ablate_ones_mismatches.restype = ctypes.c_longlong
    for fn in (lib.shimmer_packet_slab_chase_host, lib.shimmer_packet_slab_chase_split_host,
               lib.shimmer_step_attrib_packet_host,
               lib.shimmer_step_attrib_chain_host,
               lib.shimmer_step_ablate_host, lib.shimmer_step_attrib_max_packets,
               lib.shimmer_step_attrib_max_stack, lib.shimmer_ablate_next_host,
               lib.shimmer_ablate_walk_host, lib.shimmer_step_ablate_max_rows):
        fn.restype = ci
    assert lib.shimmer_step_attrib_max_packets() == ps.ATTRIB_MAX_PACKETS
    assert lib.shimmer_step_attrib_max_stack() == ps.ATTRIB_MAX_STACK
    assert lib.shimmer_step_ablate_max_rows() == ps.MAX_ABLATE_ROWS
    return lib


@pytest.fixture(scope="module")
def chase_data():
    rng = np.random.default_rng(3)
    tab_t = torch.from_numpy(rng.normal(size=(128, R)).astype(np.float32))
    nxt = rng.integers(0, R, size=(R,), dtype=np.int32)
    nxt[rng.choice(R, 4, replace=False)] = [-5, R, R + 100, -(2**31)]  # clamped into the table
    rays = torch.from_numpy(rng.normal(size=(8, P)).astype(np.float32))
    return tab_t, torch.from_numpy(nxt), rays


@pytest.mark.parametrize("transposed", [False, True], ids=["rows", "transposed"])
@pytest.mark.parametrize("body", ps.BODIES)
def test_slab_chase_body_matches_plain(host, chase_data, body, transposed):
    tab_t, nxt, rays = chase_data
    table = tab_t if transposed else tab_t.T.contiguous()
    for steps in (0, 1, 300, 5000):
        out = torch.empty(1, P)
        assert host.shimmer_packet_slab_chase_host(
            ps.BODIES.index(body), int(transposed), table.data_ptr(), R, nxt.data_ptr(),
            rays.data_ptr(), steps, out.data_ptr()) == 0
        want = ps.packet_slab_chase_plain(table, nxt, rays, steps, body, transposed)
        assert torch.equal(out, want), (body, steps)


@pytest.mark.parametrize("staged", [False, True], ids=["nxt", "staged"])
@pytest.mark.parametrize("transposed", [False, True], ids=["rows", "transposed"])
@pytest.mark.parametrize("body", ps.SPLIT_BODIES)
def test_split_chase_matches_plain_and_lane_body(host, chase_data, body, transposed, staged):
    """The card's split form of a slab or chain body (the walk from nxt or
    from its staged byte offsets, then per-lane integer counts summed over
    the slab pass's chunks of steps) against the plain version and the
    per-lane body, at step counts on both sides of a batch and across
    chunk sizes of 32 and 64 steps."""
    tab_t, nxt, rays = chase_data
    table = tab_t if transposed else tab_t.T.contiguous()
    idx = ps.BODIES.index(body)
    for steps in (0, 1, 31, 33, 300, 40000):
        split = torch.empty(1, P)
        lane = torch.empty(1, P)
        assert host.shimmer_packet_slab_chase_split_host(
            idx, int(transposed), table.data_ptr(), R, nxt.data_ptr(), rays.data_ptr(), steps,
            int(staged), split.data_ptr()) == 0
        assert host.shimmer_packet_slab_chase_host(
            idx, int(transposed), table.data_ptr(), R, nxt.data_ptr(), rays.data_ptr(), steps,
            lane.data_ptr()) == 0
        want = ps.packet_slab_chase_plain(table, nxt, rays, steps, body, transposed)
        assert torch.equal(split, want), (body, steps)
        assert torch.equal(lane, want), (body, steps)


@pytest.fixture(scope="module")
def attrib_data():
    scene, _, _ = bench_scene.build_bench_scene(1280, (16, 8), device="cpu")
    t = scene.triangles
    size = t.stack_depth + 8
    g, k = 3, 2
    rng = np.random.default_rng(4)
    rays = torch.from_numpy(rng.standard_normal((g * k, 16, P)).astype(np.float32))
    pattern = (rng.integers(0, 40, (k, size)) * 256 + rng.integers(0, 256, (k, size)))
    return t.rows8, t.meta, rays, size, k, torch.from_numpy(pattern.astype(np.int32))


def _attrib_init(stack, k, size, pattern):
    return (pattern if stack == "patterned"
            else torch.full((k, size), ps.INT32_MIN, dtype=torch.int32))


@pytest.mark.parametrize("stack", ["int32_min", "patterned"])
@pytest.mark.parametrize("variant", ps.ATTRIB_VARIANTS)
def test_step_attrib_body_matches_plain(host, attrib_data, variant, stack):
    """Row 15 as the card runs it against the plain version, the final
    stacks included: every program's packet alone (the blocks run here
    from the last to the first), its visits from slot 1 in closed form,
    the lanes' OR of hit bits per step taken after the steps, the last
    push in grid order chosen from the blocks' records."""
    rows8, meta, rays, size, k, pattern = attrib_data
    init = _attrib_init(stack, k, size, pattern)
    programs = rays.shape[0] // k
    for steps in (0, 48):
        out = torch.empty(rays.shape[0], ps.ATTRIB_OUT_ROWS, P)
        st = init.clone()
        assert host.shimmer_step_attrib_packet_host(
            ps.ATTRIB_VARIANTS.index(variant), rows8.data_ptr(), meta.data_ptr(),
            rows8.shape[0], rays.data_ptr(), programs, k, steps, size, st.data_ptr(),
            out.data_ptr()) == 0
        want, want_st = ps.step_attrib_plain(rows8, meta, rays, variant, steps, k, size, init)
        assert torch.equal(out, want), steps
        assert torch.equal(st, want_st), steps
    if stack == "patterned" and variant in ("full", "noscalar"):
        assert int((want[:, 1] >= 0).sum()) > 0
    if stack == "patterned" and variant != "noscalar":
        assert not torch.equal(want_st[:, 1:3], init[:, 1:3])  # pops and pushes landed


def test_attrib_slot1_closed_form_equals_the_pops(host):
    """attrib_slot1_after against attrib_pop popping a three-slot stack, at
    every pop count from 0 to 2 * G * 256 + 3 (G = 64, the reference's
    grid), from every low byte under the high parts 0, 1, -1, INT32_MIN >>
    8 and a random pair."""
    rng = np.random.default_rng(8)
    highs = [0, 1, -1, ps.INT32_MIN >> 8, *rng.integers(-(2**23), 2**23, 2).tolist()]
    words = np.array([(h << 8) | low for h in highs for low in range(256)], dtype=np.int64)
    words = torch.from_numpy(words.astype(np.int32))
    n_max = 2 * 64 * 256 + 3
    assert host.shimmer_attrib_slot1_mismatches(words.data_ptr(), words.numel(), n_max) == 0


@pytest.mark.parametrize("stack", ["int32_min", "patterned", "low_bytes"])
@pytest.mark.parametrize("variant", ps.ATTRIB_VARIANTS)
def test_attrib_chain_closed_form_matches_plain(host, attrib_data, variant, stack):
    """The chain the card's packet blocks compute in closed form (visits (r,
    meta[r]) per program, packet and step) against the plain attrib_chain's
    pops, over more programs than settle the pop's map; "low_bytes" starts
    slot 1 at words whose low bytes have many bits set."""
    rows8, meta, rays, size, k, pattern = attrib_data
    init = _attrib_init("patterned" if stack == "low_bytes" else stack, k, size, pattern)
    if stack == "low_bytes":
        init = init.clone()
        init[:, 1] = torch.tensor([(37 << 8) | 0xFF, (2 << 8) | 0xB6], dtype=torch.int32)[:k]
    programs, steps = 9, 12
    got = torch.empty(programs * k, steps, 2, dtype=torch.int32)
    assert host.shimmer_step_attrib_chain_host(
        ps.ATTRIB_VARIANTS.index(variant), meta.data_ptr(), meta.shape[0], programs, k, steps,
        size, init.data_ptr(), got.data_ptr()) == 0
    want = ps.step_attrib_chain_plain(meta, variant, programs, k, steps, size, init)
    assert torch.equal(got, want)
    rs, st, _ = ps.attrib_chain(meta.tolist(), meta.shape[0], programs, k, steps, size,
                                init.tolist(), variant)
    assert got[:, :, 0].tolist() == [r for g in rs for r in g]
    if variant != "noscalar" and stack != "int32_min":
        assert len(set(got[:, :, 0].flatten().tolist())) > 1  # the chain walks the table
    fake_rays = torch.zeros(programs * k, 16, P)
    assert torch.equal(ps.step_attrib_chain(rows8, meta, fake_rays, variant, steps, k, size, init),
                       want)
    # The final slot 1 of the plain pops is the closed form's after G * steps.
    words = torch.tensor([row[1] for row in init.tolist()], dtype=torch.int32)
    if variant != "noscalar":
        assert [row[1] for row in st] == [_slot1_after(w, programs * steps) for w in words.tolist()]


def _slot1_after(e: int, n: int) -> int:
    """The closed form of slot 1 (csrc/packet_step_body.cuh attrib_slot1_after)
    in Python: 8 pops, then n's parity."""
    pops = n if n <= 8 else 8 + ((n - 8) & 1)
    for _ in range(pops):
        st = [1, e, 0]
        ps._pop(st, 3, 0, 1)
        e = st[1]
    return e


@pytest.fixture(scope="module")
def ablate_data():
    n = 256
    rng = np.random.default_rng(6)
    tab = torch.from_numpy(rng.normal(size=(n, 128)).astype(np.float32))
    meta = torch.from_numpy(rng.integers(0, n, size=(n,), dtype=np.int32))
    return meta, tab, ps.pack_bf16_hilo(tab)


@pytest.mark.parametrize("variant", range(ps.ABLATE_VARIANTS))
def test_step_ablate_body_matches_plain(host, ablate_data, variant):
    meta, tab, tab_i = ablate_data
    for steps in (0, 7, 200):
        out = torch.empty(3, 8, P)
        assert host.shimmer_step_ablate_host(
            variant, meta.data_ptr(), tab.data_ptr(), tab_i.data_ptr(), meta.shape[0], 3, steps,
            -1, out.data_ptr()) == 0
        stats = {}
        want = ps.step_ablate_plain(meta, tab, tab_i, variant, steps, 3, stats=stats)
        assert torch.equal(out, want), steps
        if variant == 4 and steps == 200:
            assert 0 < stats["slab_steps"] < steps  # both branches ran


# Row 16 as the card runs it.  Tables: the reference's draws at R = 512
# (exp_ablate_step.py's order, through the entry point's make_inputs), and
# built ones: every meta word 1 (r = 1 on a self-loop: mu = 0, lambda =
# 1), every word 5 (a tail of one row into a self-loop), a three-row cycle
# through r = 1 (mu = 0, lambda = 3; v0-v2), and R = 2.
ABLATE_STEPS = (0, 1, 2, 20, 257, 2048)


def _ablate_tables(kind):
    if kind == "reference":
        case = next(c for c in eps.cases() if c.kernel == "step_ablate")
        x = eps.make_inputs(dataclasses.replace(case, n_rows=512), "cpu")
        return x["meta"], x["tab"], x["tab_i"]
    n = 2 if kind == "r2" else 64
    rng = np.random.default_rng(11)
    tab = torch.from_numpy(rng.normal(size=(n, 128)).astype(np.float32))
    if kind == "r2":
        meta = torch.tensor([1, 0], dtype=torch.int32)
    elif kind == "cycle3":
        meta = torch.from_numpy(rng.integers(0, n, n).astype(np.int32))
        meta[1], meta[2], meta[3] = 2, 3, 1
    else:
        meta = torch.full((n,), 1 if kind == "self_loop" else 5, dtype=torch.int32)
    return meta, tab, ps.pack_bf16_hilo(tab)


ABLATE_TABLES = ("reference", "self_loop", "tail_loop", "cycle3", "r2")


@pytest.mark.parametrize("kind", ABLATE_TABLES)
@pytest.mark.parametrize("variant", range(ps.ABLATE_VARIANTS))
def test_ablate_next_table_and_walk_match_plain(host, variant, kind):
    """The next table (v3 and v4: each row's lanes' OR of hits) and the
    walk to the chain's first repeated row (its rows, mu, lambda and the
    row after the last step) against the plain versions, and the walk's mu
    and lambda against the step-by-step plain version's."""
    meta, tab, tab_i = _ablate_tables(kind)
    n = meta.shape[0]
    nxt = torch.empty(n, dtype=torch.int32)
    assert host.shimmer_ablate_next_host(variant, meta.data_ptr(), tab.data_ptr(),
                                         tab_i.data_ptr(), n, nxt.data_ptr()) == 0
    want_next = ps.ablate_next_plain(meta, tab, tab_i, variant)
    assert nxt.tolist() == want_next
    for steps in ABLATE_STEPS:
        seq = torch.empty(max(1, min(steps, n)), dtype=torch.int32)
        walk = torch.empty(4, dtype=torch.int32)
        assert host.shimmer_ablate_walk_host(nxt.data_ptr(), n, steps, seq.data_ptr(),
                                             walk.data_ptr()) == 0
        rows, mu, lam, last = ps.ablate_walk_plain(want_next, steps)
        assert walk.tolist() == [len(rows), mu, lam, last] and seq[:len(rows)].tolist() == rows
        stats = {}
        ps.step_ablate_plain(meta, tab, tab_i, variant, min(steps, 300), 1, stats=stats)
        if lam and steps <= 300:
            assert (stats["mu"], stats["lam"], stats["distinct"]) == (mu, lam, mu + lam)
    _, mu, lam, _ = ps.ablate_walk_plain(want_next, 4096)
    if kind == "self_loop":
        assert (mu, lam) == (0, 1)
    elif kind == "tail_loop":
        assert (mu, lam) == (1, 1)
    elif kind == "cycle3" and variant < 3:
        assert (mu, lam) == (0, 3)


@pytest.mark.parametrize("programs", [1, 3])
@pytest.mark.parametrize("kind", ABLATE_TABLES)
@pytest.mark.parametrize("variant", range(ps.ABLATE_VARIANTS))
def test_step_ablate_card_form_matches_plain(host, variant, kind, programs):
    """Row 16 as the card computes it (next table, walk, the visited rows'
    terms held in shared memory or computed in place, the adds in step
    order, copied to every program) bit-equal to the step-by-step plain
    version, at step counts around the chain's mu + lambda too."""
    meta, tab, tab_i = _ablate_tables(kind)
    n = meta.shape[0]
    _, mu, lam, _ = ps.ablate_walk_plain(ps.ablate_next_plain(meta, tab, tab_i, variant), 4096)
    closing = (mu + lam - 1, mu + lam, mu + lam + 1) if lam else ()
    for steps in sorted({*ABLATE_STEPS, *closing} - {-1}):
        want = ps.step_ablate_plain(meta, tab, tab_i, variant, steps, programs)
        for term_rows in (-1, 0, 2):  # as the card holds them; none held; few held
            out = torch.empty(programs, 8, P)
            assert host.shimmer_step_ablate_host(variant, meta.data_ptr(), tab.data_ptr(),
                                                 tab_i.data_ptr(), n, programs, steps, term_rows,
                                                 out.data_ptr()) == 0
            assert torch.equal(out, want), (steps, term_rows)
        if steps == 0:
            assert bool((want == 1.0).all())


def test_ablate_v0_sum_stays_exact_past_2_24(host, ablate_data):
    """v0's sum in closed form, min(k, 2^24), equals float32 adds of 1.0 at
    every k up to 2^24 + 3, and the host form at 2^24 + 5 steps equals the
    adds plus the last row."""
    assert host.shimmer_ablate_ones_mismatches(2**24 + 3) == 0
    meta, tab, tab_i = ablate_data
    steps = 2**24 + 5
    out = torch.empty(1, 8, P)
    assert host.shimmer_step_ablate_host(0, meta.data_ptr(), tab.data_ptr(), tab_i.data_ptr(),
                                         meta.shape[0], 1, steps, -1, out.data_ptr()) == 0
    ones = np.add.accumulate(np.ones(steps, np.float32), dtype=np.float32)[-1]
    _, _, _, last = ps.ablate_walk_plain(ps.ablate_next_plain(meta, tab, tab_i, 0), steps)
    assert ones == np.float32(2**24)
    assert bool((out == float(np.float32(ones) + np.float32(last))).all())


def test_ablate_card_limit_holds_its_tables():
    """At MAX_ABLATE_ROWS rows the card's block holds the next table, the
    first-visit marks and the visited rows in its shared memory with room
    for terms; twice as many do not fit."""
    room = 226 * 1024
    for steps in (2048, 2 * ps.MAX_ABLATE_ROWS):
        visited = min(steps, ps.MAX_ABLATE_ROWS)
        assert 4 * ps.MAX_ABLATE_ROWS + 2 * visited + 2 * 32 * 4 <= room
    assert 4 * 2 * ps.MAX_ABLATE_ROWS > room


def test_host_bodies_reject_what_the_kernels_do_not_take(host, chase_data, ablate_data):
    tab_t, nxt, rays = chase_data
    out = torch.empty(8 * P * 8)
    assert host.shimmer_packet_slab_chase_host(8, 0, tab_t.data_ptr(), R, nxt.data_ptr(),
                                               rays.data_ptr(), 4, out.data_ptr()) == -1
    for body, steps in ((ps.BODIES.index("acc"), 4), (0, ps.MAX_CHASE_STEPS + 1)):
        assert host.shimmer_packet_slab_chase_split_host(
            body, 0, tab_t.data_ptr(), R, nxt.data_ptr(), rays.data_ptr(), steps, 0,
            out.data_ptr()) == -1
    meta, tab, tab_i = ablate_data
    assert host.shimmer_step_ablate_host(0, meta.data_ptr(), tab.data_ptr(), tab_i.data_ptr(),
                                         255, 1, 4, -1, out.data_ptr()) == -1
    assert host.shimmer_step_ablate_host(5, meta.data_ptr(), tab.data_ptr(), tab_i.data_ptr(),
                                         256, 1, 4, -1, out.data_ptr()) == -1
    # Beyond the rows the card's block stages (the host build's next table
    # and walk take any R below 2^16).
    assert host.shimmer_step_ablate_host(0, meta.data_ptr(), tab.data_ptr(), tab_i.data_ptr(),
                                         2 * ps.MAX_ABLATE_ROWS, 1, 4, -1, out.data_ptr()) == -1
    assert host.shimmer_ablate_next_host(3, meta.data_ptr(), tab.data_ptr(), tab_i.data_ptr(),
                                         255, out.data_ptr()) == -1
    assert host.shimmer_ablate_walk_host(meta.data_ptr(), 1, 4, out.data_ptr(),
                                         out.data_ptr()) == -1
    st = torch.zeros(8, 200, dtype=torch.int32)
    # Row 15 and its chain need slot 2 apart from slot 1 (stack_size >= 3).
    for packets, size in ((5, 16), (2, 200), (0, 16), (2, 2)):
        assert host.shimmer_step_attrib_packet_host(0, tab.data_ptr(), meta.data_ptr(), 256,
                                                    rays.data_ptr(), 1, packets, 4, size,
                                                    st.data_ptr(), out.data_ptr()) == -1
        assert host.shimmer_step_attrib_chain_host(0, meta.data_ptr(), 256, 1, packets, 4, size,
                                                   st.data_ptr(), st.data_ptr()) == -1


# --- the wrappers on a machine without a card ---


def test_entry_point_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        eps.main(device=None)


def test_cpu_tensors_take_the_plain_version(chase_data, attrib_data, ablate_data):
    ps.reset_launches()
    tab_t, nxt, rays = chase_data
    assert torch.equal(ps.packet_slab_chase(tab_t, nxt, rays, 50, "slab", True),
                       ps.packet_slab_chase_plain(tab_t, nxt, rays, 50, "slab", True))
    rows8, meta, arays, size, k, pattern = attrib_data
    got = ps.step_attrib(rows8, meta, arays, "full", 8, k, size, pattern)
    want = ps.step_attrib_plain(rows8, meta, arays, "full", 8, k, size, pattern)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    programs = arays.shape[0] // k
    assert torch.equal(ps.step_attrib_chain(rows8, meta, arays, "full", 8, k, size, pattern),
                       ps.step_attrib_chain_plain(meta, "full", programs, k, 8, size, pattern))
    m, tab, tab_i = ablate_data
    assert torch.equal(ps.step_ablate(m, tab, tab_i, 3, 20, 2),
                       ps.step_ablate_plain(m, tab, tab_i, 3, 20, 2))
    assert ps.launch_counts() == dict.fromkeys(ps.KERNELS, 0)


@pytest.mark.parametrize(
    "case",
    ["chase_body", "chase_layout", "chase_f64", "chase_rays_shape", "chase_nxt_i64",
     "chase_steps", "chase_steps_limit", "attrib_variant", "attrib_packets", "attrib_split", "attrib_stack_size",
     "attrib_stack_init", "ablate_variant", "ablate_rows_not_pow2", "ablate_tab_i_dtype",
     "ablate_strided", "ablate_rows_limit", "meta_device"],
)
def test_wrappers_reject_bad_arguments(chase_data, attrib_data, ablate_data, case):
    tab_t, nxt, rays = chase_data
    rows8, meta, arays, size, k, pattern = attrib_data
    m, tab, tab_i = ablate_data
    err = ValueError
    if case == "chase_body":
        fn, args = ps.packet_slab_chase, (tab_t, nxt, rays, 4, "nope", True)
    elif case == "chase_layout":
        fn, args = ps.packet_slab_chase, (tab_t, nxt, rays, 4, "slab", False)
    elif case == "chase_f64":
        fn, args, err = ps.packet_slab_chase, (tab_t.double(), nxt, rays, 4, "slab", True), TypeError
    elif case == "chase_rays_shape":
        fn, args = ps.packet_slab_chase, (tab_t, nxt, rays[:, :64].contiguous(), 4, "slab", True)
    elif case == "chase_nxt_i64":
        fn, args, err = ps.packet_slab_chase, (tab_t, nxt.long(), rays, 4, "slab", True), TypeError
    elif case == "chase_steps":
        fn, args = ps.packet_slab_chase, (tab_t, nxt, rays, -1, "slab", True)
    elif case == "chase_steps_limit":
        # Beyond 2^21 steps a lane's float sum of hit counts may round.
        fn, args = ps.packet_slab_chase, (tab_t, nxt, rays, ps.MAX_CHASE_STEPS + 1, "slab", True)
    elif case == "attrib_variant":
        fn, args = ps.step_attrib, (rows8, meta, arays, "nope", 4, k, size)
    elif case == "attrib_packets":
        fn, args = ps.step_attrib, (rows8, meta, arays, "full", 4, 5, size)
    elif case == "attrib_split":
        fn, args = ps.step_attrib, (rows8, meta, arays[:5].contiguous(), "full", 4, k, size)
    elif case == "attrib_stack_size":
        fn, args = ps.step_attrib, (rows8, meta, arays, "full", 4, k, 2)
    elif case == "attrib_stack_init":
        fn, args = ps.step_attrib, (rows8, meta, arays, "full", 4, k, size, pattern[:, :3])
    elif case == "ablate_variant":
        fn, args = ps.step_ablate, (m, tab, tab_i, 5, 4, 2)
    elif case == "ablate_rows_not_pow2":
        fn, args = ps.step_ablate, (m[:255].contiguous(), tab[:255].contiguous(),
                                    tab_i[:255].contiguous(), 0, 4, 2)
    elif case == "ablate_tab_i_dtype":
        fn, args, err = ps.step_ablate, (m, tab, tab_i.float(), 2, 4, 2), TypeError
    elif case == "ablate_strided":
        fn, args = ps.step_ablate, (m, tab.T.contiguous().T, tab_i, 2, 4, 2)
    elif case == "ablate_rows_limit":
        # More rows than the card's block stages: refused on CPU tensors too.
        n = 2 * ps.MAX_ABLATE_ROWS
        fn, args = ps.step_ablate, (torch.zeros(n, dtype=torch.int32), torch.zeros(n, 128),
                                    torch.zeros(n, 128, dtype=torch.int32), 0, 4, 2)
    else:
        fn, args = ps.step_ablate, (m.to("meta"), tab.to("meta"), tab_i.to("meta"), 0, 4, 2)
    with pytest.raises(err):
        fn(*args)


def test_library_lists_its_sources():
    source, headers = LIBRARIES["packet_step"]
    assert source == "packet_step.cu"
    for f in (source, *headers, "packet_step_host.cpp"):
        assert (CSRC / f).is_file(), f
