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
body it replaces on the card.
"""

import ctypes
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
    lib.shimmer_step_attrib_host.argtypes = [ci, p, p, ci, p, ci, ci, ci, ci, p, p]
    lib.shimmer_step_ablate_host.argtypes = [ci, p, p, p, ci, ci, ci, p]
    for fn in (lib.shimmer_packet_slab_chase_host, lib.shimmer_packet_slab_chase_split_host,
               lib.shimmer_step_attrib_host,
               lib.shimmer_step_ablate_host, lib.shimmer_step_attrib_max_packets,
               lib.shimmer_step_attrib_max_stack):
        fn.restype = ci
    assert lib.shimmer_step_attrib_max_packets() == ps.ATTRIB_MAX_PACKETS
    assert lib.shimmer_step_attrib_max_stack() == ps.ATTRIB_MAX_STACK
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


@pytest.mark.parametrize("stack", ["int32_min", "patterned"])
@pytest.mark.parametrize("variant", ps.ATTRIB_VARIANTS)
def test_step_attrib_body_matches_plain(host, attrib_data, variant, stack):
    rows8, meta, rays, size, k, pattern = attrib_data
    init = (pattern if stack == "patterned"
            else torch.full((k, size), ps.INT32_MIN, dtype=torch.int32))
    steps = 48
    programs = rays.shape[0] // k
    out = torch.empty(rays.shape[0], ps.ATTRIB_OUT_ROWS, P)
    st = init.clone()
    assert host.shimmer_step_attrib_host(
        ps.ATTRIB_VARIANTS.index(variant), rows8.data_ptr(), meta.data_ptr(), rows8.shape[0],
        rays.data_ptr(), programs, k, steps, size, st.data_ptr(), out.data_ptr()) == 0
    want, want_st = ps.step_attrib_plain(rows8, meta, rays, variant, steps, k, size, init)
    assert torch.equal(out, want)
    assert torch.equal(st, want_st)
    if stack == "patterned" and variant in ("full", "noscalar"):
        assert int((want[:, 1] >= 0).sum()) > 0


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
            out.data_ptr()) == 0
        stats = {}
        want = ps.step_ablate_plain(meta, tab, tab_i, variant, steps, 3, stats=stats)
        assert torch.equal(out, want), steps
        if variant == 4 and steps == 200:
            assert 0 < stats["slab_steps"] < steps  # both branches ran


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
                                         255, 1, 4, out.data_ptr()) == -1
    assert host.shimmer_step_ablate_host(5, meta.data_ptr(), tab.data_ptr(), tab_i.data_ptr(),
                                         256, 1, 4, out.data_ptr()) == -1
    st = torch.zeros(8, 200, dtype=torch.int32)
    for packets, size in ((5, 16), (2, 200), (0, 16)):
        assert host.shimmer_step_attrib_host(0, tab.data_ptr(), meta.data_ptr(), 256,
                                             rays.data_ptr(), 1, packets, 4, size, st.data_ptr(),
                                             out.data_ptr()) == -1


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
    m, tab, tab_i = ablate_data
    assert torch.equal(ps.step_ablate(m, tab, tab_i, 3, 20, 2),
                       ps.step_ablate_plain(m, tab, tab_i, 3, 20, 2))
    assert ps.launch_counts() == dict.fromkeys(ps.KERNELS, 0)


@pytest.mark.parametrize(
    "case",
    ["chase_body", "chase_layout", "chase_f64", "chase_rays_shape", "chase_nxt_i64",
     "chase_steps", "chase_steps_limit", "attrib_variant", "attrib_packets", "attrib_split", "attrib_stack_size",
     "attrib_stack_init", "ablate_variant", "ablate_rows_not_pow2", "ablate_tab_i_dtype",
     "ablate_strided", "meta_device"],
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
    else:
        fn, args = ps.step_ablate, (m.to("meta"), tab.to("meta"), tab_i.to("meta"), 0, 4, 2)
    with pytest.raises(err):
        fn(*args)


def test_library_lists_its_sources():
    source, headers = LIBRARIES["packet_step"]
    assert source == "packet_step.cu"
    for f in (source, *headers, "packet_step_host.cpp"):
        assert (CSRC / f).is_file(), f
