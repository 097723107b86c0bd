"""Packet-step experiments: the hand-written CUDA kernels of
``csrc/packet_step.cu``, their wrappers, and their plain torch versions.

Replaces the Pallas kernels of the reference's packet-step experiments
(kernel-table rows 10-16 in PERF.md; ``csrc/packet_step.cu`` names each
function it replaces), which time one step of a 128-ray packet's BVH
traversal and its parts:

* :func:`packet_slab_chase` (rows 10-14) -- one packet, ``steps`` visits
  of a chain from row 0: slab-test node r's 8 boxes, add each lane's hit
  count, ``r = nxt[r]``; or one of the loop-overhead bodies of row 14.
  On the card the slab and chain bodies run split: one thread walks the
  chain counting its visits of each row, then the slab tests of the
  visited rows, weighted by their counts, run over the whole card;
* :func:`step_attrib` (row 15) -- the v1 packet step body over a BVH8
  table with pieces switched off (``ATTRIB_VARIANTS``).  On the card each
  (program, packet) runs as a block of its own, its visits computed from
  the stack's slot 1 in closed form (:func:`attrib_chain` says why the
  chain never depends on a lane); :func:`step_attrib_chain` is that chain
  alone;
* :func:`step_ablate` (row 16) -- a chain ``r = meta[r]`` with one more
  ingredient of the step per variant, over a table packed by
  :func:`pack_bf16_hilo`.  On the card the programs share one
  computation: the next row is a function of the row
  (:func:`ablate_next_plain`), so a short walk to the chain's cycle
  (:func:`ablate_walk_plain`) gives every step's row, and only the adds
  stay in step order.

Each wrapper dispatches on the tensors' device: CUDA tensors launch the
kernel or raise; CPU tensors run the ``*_plain`` version.  Nothing falls
back from CUDA to the plain version.  Each wrapper counts its kernel
launches in ``.launches``.  The kernel library ``packet_step`` is built at
first use by the port's shared nvcc build (``ops/cuda_build.py``).

A chase reads ``nxt[r]`` (``meta[r]``) clamped into the table, where the
reference reads it unchecked; on a valid table the two agree.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from shimmer_tpu_torch.ops import cuda_build
from shimmer_tpu_torch.ops.math import difference_of_products

LANES = 128        # P: rays of a packet
NODE_WIDTH = 128   # floats of a table row
BOX_FLOATS = 48
# Kernel A's bodies, by their index in csrc/packet_step_body.cuh.
BODIES = ("slab", "slab_stack", "empty", "slab_fixed", "int_sum", "chase", "acc", "acc_scaled")
FIXED_STRIDE = 37  # k5: r = (i * 37) % R
# The bodies the kernel splits into a chain walk and a slab pass spread
# over the card (csrc/packet_step_body.cuh, "Kernel A split"); the others
# keep the per-lane loop, whose float sums depend on their order.
SPLIT_BODIES = ("slab", "slab_stack", "empty", "slab_fixed", "chase")
# The split bodies whose walk counts its visits of each row in one block's
# shared memory, and the most rows it holds (kMaxSharedRows).
COUNTED_BODIES = ("slab", "slab_stack")
MAX_COUNTED_ROWS = (227 * 1024 - 8 * 1024) // 4
# The most steps a chase takes (kChaseMaxSteps): a lane's hit count, at
# most 8 a step, stays an exact float32 integer (8 * steps <= 2^24), so the
# split's integer total equals the per-lane float sum.  The reference's
# largest case is 2^20 steps.
MAX_CHASE_STEPS = 2**21
# Kernel B's variants (exp_step_attrib.py's names), by index.
ATTRIB_VARIANTS = ("full", "noroll", "noleaf", "noint", "nobits", "noscalar")
ATTRIB_RAY_ROWS = 16
ATTRIB_OUT_ROWS = 8
ATTRIB_CONST_BITS = 3
ATTRIB_T_INIT = 1e30
# Packets of a program and stack slots of a packet, at most
# (kAttribMaxPackets, kAttribMaxStack).
ATTRIB_MAX_PACKETS = 4
ATTRIB_MAX_STACK = 128
# What an int32 scratch slot holds before it is written, in the
# reference's interpret mode (jax._src.pallas.primitives.uninitialized_value).
INT32_MIN = -(2**31)
# Kernel C's variants v0-v4 are 0-4, and the most rows its block stages
# on the card (kAblateMaxRows: the next table and first-visit marks, 16
# bits a row each, beside the visited rows in 227 KB of shared memory).
ABLATE_VARIANTS = 5
MAX_ABLATE_ROWS = 32768
_INT_MAX = 2**31 - 1

_lock = threading.Lock()
_lib = None


def _library():
    """The ``packet_step`` library with its C signatures, built and loaded
    at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = cuda_build.load("packet_step")
            p, ci = ctypes.c_void_p, ctypes.c_int
            lib.shimmer_packet_slab_chase.argtypes = [ci, ci, p, ci, p, p, ci, p, p, p]
            lib.shimmer_packet_slab_chase_max_steps.argtypes = []
            lib.shimmer_packet_slab_chase_max_rows.argtypes = []
            lib.shimmer_step_attrib.argtypes = [ci, p, p, ci, p, ci, ci, ci, ci, p, p, p, p]
            lib.shimmer_step_attrib_chain.argtypes = [ci, p, ci, ci, ci, ci, ci, p, p, p]
            lib.shimmer_step_ablate.argtypes = [ci, p, p, p, ci, ci, ci, p, p, p]
            bounds = (lib.shimmer_step_attrib_max_packets, lib.shimmer_step_attrib_max_stack,
                      lib.shimmer_packet_slab_chase_max_steps,
                      lib.shimmer_packet_slab_chase_max_rows, lib.shimmer_step_ablate_max_rows)
            for fn in bounds:
                fn.argtypes = []
            for fn in (lib.shimmer_packet_slab_chase, lib.shimmer_step_attrib,
                       lib.shimmer_step_attrib_chain, lib.shimmer_step_ablate, *bounds):
                fn.restype = ci
            if tuple(fn() for fn in bounds) != (ATTRIB_MAX_PACKETS, ATTRIB_MAX_STACK,
                                                 MAX_CHASE_STEPS, MAX_COUNTED_ROWS,
                                                 MAX_ABLATE_ROWS):
                raise cuda_build.KernelBuildError("packet-step bounds disagree with the wrapper")
            _lib = lib
        return _lib


def _count(name: str, value: int, lo: int, hi: int = _INT_MAX) -> int:
    value = int(value)
    if not lo <= value <= hi:
        raise ValueError(f"{name}={value} out of range [{lo}, {hi}]")
    return value


def _device_type(t) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no packet-step kernel for device {t.device}")
    if t.device.type == "cuda" and t.data_ptr() % 16:
        raise ValueError("tables must be 16-byte aligned on the card")
    return t.device.type


# --- kernel A: the packet slab chase (rows 10-14) ---


def packet_slab_chase(table, nxt, rays, steps: int, body: str = "slab", transposed: bool = False):
    """One packet down a chain of ``steps`` visits from row 0 (the bodies
    are ``BODIES``; see csrc/packet_step_body.cuh).  table: (R, 128)
    float32 node rows, or (128, R) with ``transposed``, whose elements
    0:48 are the 8 boxes [lox*8 | loy*8 | loz*8 | hix*8 | hiy*8 | hiz*8];
    nxt: (R,) int32; rays: (8, 128) float32, origin in rows 0-2, inverse
    direction in rows 3-5; steps at most ``MAX_CHASE_STEPS``.  Returns the
    (1, 128) float32 output.  On the card a split body (``SPLIT_BODIES``)
    is up to two launches, the chain walk and the slab pass, counted as one
    call of the kernel; slab and slab_stack take at most
    ``MAX_COUNTED_ROWS`` rows there."""
    if body not in BODIES:
        raise ValueError(f"body {body!r} is not one of {BODIES}")
    dev = table.device
    n_rows = nxt.shape[0] if nxt.dim() == 1 else -1
    cuda_build.check_tensor("nxt", nxt, torch.int32, (max(n_rows, 1),), dev)
    shape = (NODE_WIDTH, n_rows) if transposed else (n_rows, NODE_WIDTH)
    cuda_build.check_tensor("table", table, torch.float32, shape, dev)
    cuda_build.check_tensor("rays", rays, torch.float32, (8, LANES), dev)
    steps = _count("steps", steps, 0, MAX_CHASE_STEPS)
    if _device_type(table) == "cpu":
        return packet_slab_chase_plain(table, nxt, rays, steps, body, transposed)
    if body in COUNTED_BODIES and n_rows > MAX_COUNTED_ROWS:
        raise ValueError(f"the card's {body} chase counts the visits of at most "
                         f"{MAX_COUNTED_ROWS} rows, got {n_rows}")
    out = torch.empty(1, LANES, dtype=torch.float32, device=dev)
    # The split bodies' scratch: the visited rows and their counts, their
    # number, the per-lane sums and the slab pass's finished-block count.
    listed = min(steps, n_rows) if body in COUNTED_BODIES else 0
    work = torch.empty(2 * listed + LANES + 2, dtype=torch.int32, device=dev)
    cuda_build.raise_on_error(_library().shimmer_packet_slab_chase(
        BODIES.index(body), int(transposed), table.data_ptr(), n_rows, nxt.data_ptr(),
        rays.data_ptr(), steps, work.data_ptr(), out.data_ptr(), cuda_build.stream_of(table)),
        "packet_slab_chase")
    packet_slab_chase.launches["packet_slab_chase"] += 1
    return out


packet_slab_chase.launches = {"packet_slab_chase": 0}


def chase_visits(nxt: list, n_rows: int, steps: int, r0: int = 0):
    """The chain r -> nxt[r] (clamped into [0, R)) from ``r0`` over
    ``steps`` visits: (the distinct rows in order of first visit, how often
    each is visited, the row after the last visit).  Walks to the first
    repeated row, then counts whole laps of the cycle it closed."""
    first, order = {}, []
    r = r0
    while len(order) < steps and r not in first:
        first[r] = len(order)
        order.append(r)
        r = min(max(nxt[r], 0), n_rows - 1)
    if len(order) == steps:
        return order, [1] * steps, r
    start = first[r]
    laps, rem = divmod(steps - start, len(order) - start)
    counts = [1] * start + [laps + (j < rem) for j in range(len(order) - start)]
    return order, counts, order[start + rem]


def node_boxes(table, rows, transposed: bool):
    """(M, 48) box floats of the nodes ``rows`` (a long tensor)."""
    return table[:BOX_FLOATS, rows].T if transposed else table[rows, :BOX_FLOATS]


def slab_hits_plain(boxes, rays):
    """(M, 128) int64: each lane's hits against each node's 8 boxes,
    (tn <= tf) & (tf > 0), in the kernel's operation order."""
    b = boxes[:, :, None]
    ox, oy, oz, ix, iy, iz = (rays[c][None, None, :] for c in range(6))
    t0x = (b[:, 0:8] - ox) * ix
    t1x = (b[:, 24:32] - ox) * ix
    t0y = (b[:, 8:16] - oy) * iy
    t1y = (b[:, 32:40] - oy) * iy
    t0z = (b[:, 16:24] - oz) * iz
    t1z = (b[:, 40:48] - oz) * iz
    tn = torch.maximum(torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
                       torch.minimum(t0z, t1z))
    tf = torch.minimum(torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
                       torch.maximum(t0z, t1z))
    return ((tn <= tf) & (tf > 0.0)).sum(1)


def packet_slab_chase_plain(table, nxt, rays, steps: int, body: str = "slab",
                            transposed: bool = False, stats: dict | None = None):
    """Plain torch version of :func:`packet_slab_chase`.  The slab bodies
    take the reference oracle's visit-count form (exp_scaling.py:96-112):
    per-node hit counts times the visits of each node, summed in int64;
    the kernel's float32 running sum of whole hit counts is exact, so the
    two are bit-equal while 8 * steps < 2^24.  ``acc`` / ``acc_scaled``
    add in the kernel's order, one step at a time.  ``stats``, a dict or
    None, receives ``rows_read`` (distinct rows whose boxes were read) and
    ``nxt_read`` (distinct nxt words read)."""
    n_rows = nxt.shape[0]
    dev = rays.device
    steps = int(steps)
    rows_read = nxt_read = 0
    if body == "int_sum":
        s = (steps * (steps - 1) // 2) % 2**32
        out = torch.full((1, LANES), float(s - 2**32 if s >= 2**31 else s), device=dev)
    elif body in ("acc", "acc_scaled"):
        x = rays[0:1]
        acc = torch.zeros(1, LANES, dtype=torch.float32, device=dev)
        for i in range(steps):
            acc = acc + (x if body == "acc" else x * float(i))
        out = acc
    else:
        if body == "slab_fixed":
            seq = torch.arange(steps, dtype=torch.int64, device=dev) * FIXED_STRIDE % n_rows
            counts = torch.bincount(seq, minlength=n_rows)
            rows = torch.nonzero(counts).squeeze(1)
            counts = counts[rows]
            final = None
        else:
            order, counts, final = chase_visits(nxt.tolist(), n_rows, steps)
            rows = torch.tensor(order, dtype=torch.int64, device=dev)
            counts = torch.tensor(counts, dtype=torch.int64, device=dev)
            nxt_read = len(order)
        if body == "empty":
            out = torch.zeros(1, LANES, dtype=torch.float32, device=dev)
        elif body == "chase":
            out = torch.full((1, LANES), float(final), device=dev)
        else:
            hits = slab_hits_plain(node_boxes(table, rows, transposed), rays)
            out = (counts[:, None] * hits).sum(0, keepdim=True).to(torch.float32)
            rows_read = int(rows.numel())
    if stats is not None:
        stats["rows_read"] = rows_read
        stats["nxt_read"] = nxt_read
    return out


# --- kernel B: step attribution (row 15) ---


def _attrib_args(rows8, meta, rays, variant, steps, packets, stack_size, stack_init):
    if variant not in ATTRIB_VARIANTS:
        raise ValueError(f"variant {variant!r} is not one of {ATTRIB_VARIANTS}")
    dev = rows8.device
    n_rows = rows8.shape[0] if rows8.dim() == 2 else -1
    cuda_build.check_tensor("rows8", rows8, torch.float32, (max(n_rows, 1), NODE_WIDTH),
                            dev)
    cuda_build.check_tensor("meta", meta, torch.int32, (n_rows,), dev)
    packets = _count("packets", packets, 1, ATTRIB_MAX_PACKETS)
    n_packets = rays.shape[0] if rays.dim() == 3 else -1
    if n_packets % packets:
        raise ValueError(f"{n_packets} ray packets do not split into programs of {packets}")
    cuda_build.check_tensor("rays", rays, torch.float32,
                            (max(n_packets, 0), ATTRIB_RAY_ROWS, LANES), dev)
    # At least 3 slots, so that pops (slot 1) and pushes (slot 2) never
    # meet: the plain version's chain rests on it (attrib_chain).
    stack_size = _count("stack_size", stack_size, 3, ATTRIB_MAX_STACK)
    if stack_init is None:
        stack_init = torch.full((packets, stack_size), INT32_MIN, dtype=torch.int32, device=dev)
    cuda_build.check_tensor("stack_init", stack_init, torch.int32, (packets, stack_size), dev)
    steps = _count("steps", steps, 0)
    return dev, n_rows, n_packets // packets, packets, steps, stack_size, stack_init


def step_attrib(rows8, meta, rays, variant: str, steps: int, packets: int, stack_size: int,
                stack_init=None):
    """Row 15's step body (exp_step_attrib.py::kern) over the BVH8 table
    (rows8 (R, 128) float32, meta (R,) int32): G = rays.shape[0] / packets
    programs of ``packets`` packets each, ``steps`` steps a program.  rays:
    (G * packets, 16, 128) float32.  The stack of ``stack_size`` slots (the
    reference sizes it stack_depth + 8) starts as ``stack_init`` ((packets,
    stack_size) int32; default INT32_MIN everywhere, what interpret mode's
    scratch holds) and carries from one program to the next in grid order,
    as the reference's scratch does in interpret mode; slot 0 is set to 1
    at each program's start.  On the card the programs run side by side
    (two launches: the packet blocks, then a finish that writes the stacks).
    Returns (out (G * packets, 8, 128) float32: row 0 t_best, row 1 tri,
    rows 2-7 zero; the (packets, stack_size) stack as the last program
    left it)."""
    dev, n_rows, programs, packets, steps, stack_size, stack_init = _attrib_args(
        rows8, meta, rays, variant, steps, packets, stack_size, stack_init)
    if _device_type(rows8) == "cpu":
        return step_attrib_plain(rows8, meta, rays, variant, steps, packets, stack_size,
                                 stack_init)
    stack = stack_init.clone()
    out = torch.empty(programs * packets, ATTRIB_OUT_ROWS, LANES, dtype=torch.float32,
                      device=dev)
    # Each block's last push (step + 1, word), read by the finish launch.
    work = torch.empty(programs * packets, 2, dtype=torch.int32, device=dev)
    cuda_build.raise_on_error(_library().shimmer_step_attrib(
        ATTRIB_VARIANTS.index(variant), rows8.data_ptr(), meta.data_ptr(), n_rows,
        rays.data_ptr(), programs, packets, steps, stack_size, stack.data_ptr(),
        work.data_ptr(), out.data_ptr(), cuda_build.stream_of(rows8)), "step_attrib")
    step_attrib.launches["step_attrib"] += 1
    return out, stack


step_attrib.launches = {"step_attrib": 0}


def step_attrib_chain(rows8, meta, rays, variant: str, steps: int, packets: int,
                      stack_size: int, stack_init=None):
    """Row 15's chain alone, with :func:`step_attrib`'s arguments: the
    (G * packets, steps, 2) int32 visits, (r, meta[r]) of each program's
    packet's step, as the card's packet blocks compute them from the
    stacks' slot 1 (rows8 and the rays are checked, not read)."""
    dev, n_rows, programs, packets, steps, stack_size, stack_init = _attrib_args(
        rows8, meta, rays, variant, steps, packets, stack_size, stack_init)
    if _device_type(rows8) == "cpu":
        return step_attrib_chain_plain(meta, variant, programs, packets, steps, stack_size,
                                       stack_init)
    visits = torch.empty(programs * packets, steps, 2, dtype=torch.int32, device=dev)
    cuda_build.raise_on_error(_library().shimmer_step_attrib_chain(
        ATTRIB_VARIANTS.index(variant), meta.data_ptr(), n_rows, programs, packets, steps,
        stack_size, stack_init.data_ptr(), visits.data_ptr(), cuda_build.stream_of(meta)),
        "step_attrib_chain")
    step_attrib_chain.launches["step_attrib_chain"] += 1
    return visits


step_attrib_chain.launches = {"step_attrib_chain": 0}


def step_attrib_chain_plain(meta, variant: str, programs: int, packets: int, steps: int,
                            stack_size: int, stack_init):
    """Plain torch version of :func:`step_attrib_chain`, from
    :func:`attrib_chain`."""
    meta_l = meta.tolist()
    rs, _, _ = attrib_chain(meta_l, meta.shape[0], programs, packets, steps, stack_size,
                            stack_init.tolist(), variant)
    r = torch.tensor(rs, dtype=torch.int64).reshape(programs * packets, steps)
    m = torch.tensor(meta_l, dtype=torch.int32)[r]
    return torch.stack([r.to(torch.int32), m], 2).to(meta.device)


def _pop(st: list, stack_size: int, i: int, n_rows: int):
    """The packet's pop on its stack row ``st`` (a list, updated): (r, sp)."""
    sp = max(st[0] % stack_size, 0)
    e = st[sp]
    lsb = (e & 255) & -(e & 255)
    j = (1 if lsb & 0xAA else 0) + (2 if lsb & 0xCC else 0) + (4 if lsb & 0xF0 else 0)
    rest = e - lsb
    st[sp] = e | 1 if rest == 0 else rest
    return min(max((e >> 8) + j + i, 0), n_rows - 1), sp


def _push_word(m: int, bits: int) -> int:
    w = (((m >> 4) << 8) | bits) & 0xFFFFFFFF
    return w - 2**32 if w >= 2**31 else w


def attrib_chain(meta: list, n_rows: int, programs: int, packets: int, steps: int,
                 stack_size: int, stack_init: list, variant: str):
    """Row 15's scalar chain on the host: r per (program, packet, step)
    (a nested list) and the stacks after the pops (a list of lists, updated
    from ``stack_init``), with each visit's (sp, meta word).

    The pushes need the lanes' bits, so the caller applies them.  They never
    change r: slot 0 is 1 at every program's start and only a pop at sp = 0
    or a push into slot 0 could change it, so sp = 1 % stack_size = 1 at
    every pop and every push lands in slot min(2, stack_size - 1) = 2 with
    stack_size >= 3, a slot that no pop reads.  So r depends only on the
    pops, and with interpret mode's INT32_MIN in slot 1 it is 0 throughout
    ((INT32_MIN >> 8) + i < 0 and the pop leaves INT32_MIN in place).  The
    pops' map on slot 1 reaches a cycle of period 1 or 2 within 8 pops, so
    the card computes slot 1's word at any pop in closed form
    (csrc/packet_step_body.cuh, attrib_slot1_after)."""
    st = [list(row) for row in stack_init]
    rs, visits = [], []
    for g in range(programs):
        for k in range(packets):
            st[k][0] = 1
        rs.append([[0] * steps for _ in range(packets)])
        visits.append([[None] * steps for _ in range(packets)])
        for k in range(packets):
            for i in range(steps):
                if variant == "noscalar":
                    rs[g][k][i] = i * (k + 3) % n_rows
                    continue
                r, sp = _pop(st[k], stack_size, i, n_rows)
                if sp != 1:
                    raise AssertionError(f"pop at slot {sp}: the chain would depend on the pushes")
                rs[g][k][i] = r
                visits[g][k][i] = (sp, meta[r])
    return rs, st, visits


def step_attrib_plain(rows8, meta, rays, variant: str, steps: int, packets: int,
                      stack_size: int, stack_init, stats: dict | None = None):
    """Plain torch version of :func:`step_attrib`.  The scalar chain runs on
    the host (:func:`attrib_chain`); the lane arithmetic runs for all
    programs' packets at once, a step at a time, in the kernel's operation
    order (programs share nothing but the stack, whose pushes never reach
    the chain).  ``stats``, a dict or None, receives ``rows_read`` and
    ``meta_read`` (distinct rows and meta words read) and ``leaf_slots``
    (the leaf tests the packets' steps ask for: min(cnt, 8) a step)."""
    dev = rows8.device
    n_rows = rows8.shape[0]
    n = rays.shape[0]
    programs = n // packets
    rs, st, visits = attrib_chain(meta.tolist(), n_rows, programs, packets, steps, stack_size,
                                  stack_init.tolist(), variant)
    r_all = torch.tensor(rs, dtype=torch.int64, device=dev).reshape(n, steps)
    ox, oy, oz, dx, dy, dz = (rays[:, c, None, :] for c in range(6))
    want_any = rays[:, 7] > 0.0
    ix, iy, iz, sx, sy, sz = (rays[:, c, None, :] for c in range(8, 14))
    pc = rays[:, 14, None, :]
    is0 = pc < 0.5
    is1 = (pc >= 0.5) & (pc < 1.5)
    dz_ok = rays[:, 15, None, :] > 0.0
    iota8 = torch.arange(8, device=dev)[None, :, None]
    pow2 = (1 << torch.arange(8, device=dev))[None, :]
    t_best = torch.full((n, LANES), ATTRIB_T_INIT, dtype=torch.float32, device=dev)
    tri = torch.full((n, LANES), -1.0, dtype=torch.float32, device=dev)
    active = torch.ones(n, LANES, dtype=torch.float32, device=dev)
    bits_all = []
    rows_read, meta_read = set(), set()
    leaf_slots = 0

    def permute(x, y, z):
        return (torch.where(is0, y, torch.where(is1, z, x)),
                torch.where(is0, z, torch.where(is1, x, y)),
                torch.where(is0, x, torch.where(is1, y, z)))

    for i in range(steps):
        r = r_all[:, i]
        node = r & ~7 if variant == "noroll" else r
        row = rows8[node]
        internal = (meta[node] & 15) == 0
        cnt = r & 3 if variant == "noscalar" else meta[r].long() & 15
        if stats is not None:
            rows_read.update(node.tolist())
            meta_read.update(r.tolist() + node.tolist())
            leaf_slots += int(cnt.clamp(max=8).sum())

        def fld(c):
            if c == 6:
                return torch.where(internal[:, None], row[:, 88:96], row[:, 48:56])[:, :, None]
            return row[:, 8 * c:8 * c + 8, None]

        if variant in ("full", "noroll", "noleaf"):
            t0x = (fld(0) - ox) * ix
            t1x = (fld(3) - ox) * ix
            t0y = (fld(1) - oy) * iy
            t1y = (fld(4) - oy) * iy
            t0z = (fld(2) - oz) * iz
            t1z = (fld(5) - oz) * iz
            tn = torch.maximum(torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
                               torch.minimum(t0z, t1z))
            tf = torch.minimum(torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
                               torch.maximum(t0z, t1z))
            hit8 = ((tn <= tf * 1.0001) & (tf > 0.0) & (tn < t_best[:, None, :])
                    & (fld(6) > 0.0) & (active[:, None, :] > 0.0))
            bits_all.append((hit8.any(2) * pow2).sum(1))
        else:
            bits_all.append(torch.full((n,), ATTRIB_CONST_BITS, dtype=torch.int64, device=dev))
        if variant == "noleaf":
            continue
        q0 = permute(fld(0) - ox, fld(1) - oy, fld(2) - oz)
        q1 = permute(fld(3) - ox, fld(4) - oy, fld(5) - oz)
        q2 = permute(fld(6) - ox, fld(7) - oy, fld(8) - oz)
        x0, y0 = q0[0] + sx * q0[2], q0[1] + sy * q0[2]
        x1, y1 = q1[0] + sx * q1[2], q1[1] + sy * q1[2]
        x2, y2 = q2[0] + sx * q2[2], q2[1] + sy * q2[2]
        e0 = difference_of_products(x1, y2, y1, x2)
        e1 = difference_of_products(x2, y0, y2, x0)
        e2 = difference_of_products(x0, y1, y0, x1)
        same_sign = (((e0 >= 0) & (e1 >= 0) & (e2 >= 0))
                     | ((e0 <= 0) & (e1 <= 0) & (e2 <= 0)))
        det = e0 + e1 + e2
        det_ok = det != 0.0
        ts = e0 * (q0[2] * sz) + e1 * (q1[2] * sz) + e2 * (q2[2] * sz)
        neg = det < 0.0
        tb = t_best[:, None, :]
        t_ok = ((neg & (ts <= 1e-7 * det) & (ts > tb * det))
                | (~neg & (ts >= 1e-7 * det) & (ts < tb * det)))
        hit = (same_sign & det_ok & t_ok & dz_ok & (iota8 < cnt[:, None, None])
               & (active[:, None, :] > 0.0))
        inv_det = 1.0 / torch.where(det_ok, det, 1.0)
        t = torch.where(hit, ts * inv_det, float("inf"))
        tmin = t.min(1).values
        sel = torch.where(t == tmin[:, None, :], iota8, 8).min(1).values.clamp(max=7)
        win_id = row[:, 72:80].gather(1, sel)
        closer = tmin < t_best
        t_best = torch.where(closer, tmin, t_best)
        tri = torch.where(closer, win_id, tri)
        active = torch.where(want_any[:, :] & closer, 0.0, active)

    # The pushes, in grid order: into slot 2 (attrib_chain), the last one
    # with bits != 0 stays.
    if variant != "noscalar" and steps > 0 and programs > 0:
        bits = torch.stack(bits_all, 1).reshape(programs, packets, steps).tolist()
        for g in range(programs):
            for k in range(packets):
                for i in range(steps):
                    sp, m = visits[g][k][i]
                    if bits[g][k][i] != 0:
                        st[k][min(sp + 1, stack_size - 1)] = _push_word(m, bits[g][k][i])
    out = torch.zeros(n, ATTRIB_OUT_ROWS, LANES, dtype=torch.float32, device=dev)
    out[:, 0] = t_best
    out[:, 1] = tri
    if stats is not None:
        stats["rows_read"] = len(rows_read)
        stats["meta_read"] = len(meta_read)
        stats["leaf_slots"] = leaf_slots
    return out, torch.tensor(st, dtype=torch.int32, device=dev)


# --- kernel C: step ablation (row 16) ---


def _u32_to_i32(u):
    """int64 values in [0, 2^32) -> the int32 with the same bits."""
    return torch.where(u >= 2**31, u - 2**32, u).to(torch.int32)


def pack_bf16_hilo(table):
    """(R, W) float32 -> (R, W) int32 words: the bf16 (round to nearest
    even) of each float in the upper 16 bits, the bf16 of its remainder in
    the lower 16 (exp_ablate_step.py:24-27).  The shifts run in int64
    masked to 32 bits: int32 ``<<`` would overflow and int32 ``>>`` is
    arithmetic."""
    if table.dtype != torch.float32:
        raise TypeError(f"table has dtype {table.dtype}, expected torch.float32")
    hi = table.to(torch.bfloat16)
    lo = (table - hi.to(torch.float32)).to(torch.bfloat16)
    hb = hi.view(torch.int16).to(torch.int64) & 0xFFFF
    lb = lo.view(torch.int16).to(torch.int64) & 0xFFFF
    return _u32_to_i32((hb << 16) | lb)


def hilo_values(words):
    """float32 hi + lo of packed words (the kernel's hilo_value)."""
    u = words.to(torch.int64) & 0xFFFFFFFF
    hi = _u32_to_i32(u & 0xFFFF0000).view(torch.float32)
    lo = _u32_to_i32((u << 16) & 0xFFFFFFFF).view(torch.float32)
    return hi + lo


def _ablate_args(meta, tab, tab_i, variant, steps, programs):
    dev = meta.device
    n_rows = meta.shape[0] if meta.dim() == 1 else -1
    if n_rows < 2 or n_rows & (n_rows - 1):
        raise ValueError(f"meta must have a power-of-two length >= 2, got {tuple(meta.shape)}")
    if n_rows > MAX_ABLATE_ROWS:
        raise ValueError(f"the card's step ablation stages at most {MAX_ABLATE_ROWS} rows, "
                         f"got {n_rows}")
    cuda_build.check_tensor("meta", meta, torch.int32, (n_rows,), dev)
    cuda_build.check_tensor("tab", tab, torch.float32, (n_rows, NODE_WIDTH), dev)
    cuda_build.check_tensor("tab_i", tab_i, torch.int32, (n_rows, NODE_WIDTH), dev)
    return (dev, n_rows, _count("variant", variant, 0, ABLATE_VARIANTS - 1),
            _count("steps", steps, 0), _count("programs", programs, 0))


def step_ablate(meta, tab, tab_i, variant: int, steps: int, programs: int = 64):
    """Row 16's kernel (exp_ablate_step.py::kern), variant v0-v4 (0-4):
    each of ``programs`` programs runs one packet down the chain from
    r = 1 for ``steps`` steps.  meta: (R,) int32, R a power of two; tab:
    (R, 128) float32; tab_i: (R, 128) int32, :func:`pack_bf16_hilo` of
    tab.  Returns (programs, 8, 128) float32, acc + float(r) of each.  R
    is at most ``MAX_ABLATE_ROWS`` (what the card's block stages; CPU
    tensors are held to it too); on the card v3 and v4 are two launches
    (the next table, then the walk and sums), counted as one call."""
    dev, n_rows, variant, steps, programs = _ablate_args(meta, tab, tab_i, variant, steps,
                                                         programs)
    if _device_type(tab) == "cpu":
        return step_ablate_plain(meta, tab, tab_i, variant, steps, programs)
    _device_type(tab_i)
    _device_type(meta)  # read 16 bytes at a time
    out = torch.empty(programs, 8, LANES, dtype=torch.float32, device=dev)
    work = torch.empty(n_rows, dtype=torch.int32, device=dev)  # v3, v4: the next table
    cuda_build.raise_on_error(_library().shimmer_step_ablate(
        variant, meta.data_ptr(), tab.data_ptr(), tab_i.data_ptr(), n_rows, programs, steps,
        work.data_ptr(), out.data_ptr(), cuda_build.stream_of(tab)), "step_ablate")
    step_ablate.launches["step_ablate"] += 1
    return out


step_ablate.launches = {"step_ablate": 0}


def step_ablate_plain(meta, tab, tab_i, variant: int, steps: int, programs: int,
                      stats: dict | None = None):
    """Plain torch version of :func:`step_ablate`: one program, a step at a
    time in the kernel's order, copied to every program.  ``stats``, a
    dict or None, receives ``bytes_read`` (the distinct table words the
    steps read: 8 floats of a row for v1, 16 for v4's leaf branch, 40
    packed words for the slab), ``meta_read`` (distinct meta words),
    ``slab_steps`` (the steps that ran the slab; v4 splits its steps on
    r & 1), ``slab_rows`` and ``leaf_rows`` (the distinct rows of each
    branch), and the chain's shape as the steps met it: ``distinct`` rows,
    the tail ``mu`` before its cycle and the cycle's length ``lam`` (0: no
    row repeated within the steps)."""
    dev = tab.device
    n_rows = meta.shape[0]
    nxt = meta.tolist()
    ox = torch.arange(LANES, dtype=torch.float32, device=dev) * 0.01 + 0.5
    pow2 = 1 << torch.arange(8, device=dev)
    acc = torch.zeros(8, LANES, dtype=torch.float32, device=dev)
    f32_rows, leaf_rows, slab_rows, meta_read = set(), set(), set(), set()
    slab_steps = 0
    first, mu, lam = {}, None, 0

    def step_to(idx):
        meta_read.add(idx)
        return min(max(nxt[idx], 0), n_rows - 1)

    r = 1
    for i in range(int(steps)):
        if mu is None:
            if r in first:
                mu, lam = first[r], i - first[r]
            else:
                first[r] = i
        if variant == 0:
            acc = acc + 1.0
            r = step_to(r)
            continue
        if variant == 1:
            f32_rows.add(r)
            acc = acc + tab[r, 0:8, None]
            r = step_to(r)
            continue
        if variant == 4 and r & 1:
            leaf_rows.add(r)
            row = tab[r]
            acc = acc + row[0:8, None] * row[8:16, None]
            bits = LANES * int(((row[0:8] * 0.0 > 1.0) * pow2).sum()) + 1
            r = step_to((r + bits) & (n_rows - 1))
            continue
        slab_steps += 1
        slab_rows.add(r)
        c = hilo_values(tab_i[r, 0:56])[:, None]
        t0 = (c[0:8] - ox) * 1.7
        t1 = (c[24:32] - ox) * 1.7
        t0y = (c[8:16] - ox) * 0.9
        t1y = (c[32:40] - ox) * 0.9
        tn = torch.maximum(torch.minimum(t0, t1), torch.minimum(t0y, t1y))
        tf = torch.minimum(torch.maximum(t0, t1), torch.maximum(t0y, t1y))
        hit = (tn <= tf * 1.0001) & (c[48:56] > 0.0)
        acc = acc + tn
        if variant == 2:
            acc = acc + hit.to(torch.float32)
            r = step_to(r)
        else:
            bits = int((hit.any(1) * pow2).sum())
            r = step_to((r + bits) & (n_rows - 1))
    if stats is not None:
        stats["bytes_read"] = 4 * (8 * len(f32_rows) + 16 * len(leaf_rows) + 40 * len(slab_rows))
        stats["meta_read"] = len(meta_read)
        stats["slab_steps"] = slab_steps
        stats["slab_rows"] = len(slab_rows)
        stats["leaf_rows"] = len(leaf_rows)
        stats["distinct"] = len(first)
        stats["mu"] = len(first) if mu is None else mu
        stats["lam"] = lam
    out = acc + float(r)
    return out[None].expand(programs, 8, LANES).contiguous()


def ablate_next_plain(meta, tab, tab_i, variant: int) -> list:
    """Row 16's next row of every row, next_v(r) (csrc/packet_step_body.cuh,
    "The design"): meta[r] for v0-v2; for v3 and v4 meta[(r + bits(r)) &
    (R - 1)], bits(r) the OR over the lanes of row r's slab hits (v4's odd
    rows: its leaf branch's bits); meta's words clamped into the table."""
    n_rows = meta.shape[0]
    dev = tab.device
    rows = torch.arange(n_rows, device=dev)
    if variant in (3, 4):
        ox = torch.arange(LANES, dtype=torch.float32, device=dev) * 0.01 + 0.5
        pow2 = 1 << torch.arange(8, device=dev)
        c = hilo_values(tab_i[:, 0:56])[:, :, None]
        t0 = (c[:, 0:8] - ox) * 1.7
        t1 = (c[:, 24:32] - ox) * 1.7
        t0y = (c[:, 8:16] - ox) * 0.9
        t1y = (c[:, 32:40] - ox) * 0.9
        tn = torch.maximum(torch.minimum(t0, t1), torch.minimum(t0y, t1y))
        tf = torch.minimum(torch.maximum(t0, t1), torch.maximum(t0y, t1y))
        hit = (tn <= tf * 1.0001) & (c[:, 48:56] > 0.0)
        bits = (hit.any(2) * pow2).sum(1)
        if variant == 4:
            leaf = LANES * ((tab[:, 0:8] * 0.0 > 1.0) * pow2).sum(1) + 1
            bits = torch.where(rows % 2 == 1, leaf, bits)
        rows = (rows + bits) & (n_rows - 1)
    return meta.long()[rows].clamp(0, n_rows - 1).tolist()


def ablate_walk_plain(nxt: list, steps: int):
    """The chain from r = 1 over the next table ``nxt`` (a list), walked to
    its first repeated row or ``steps`` steps: (the rows in step order,
    mu, lam, the row after the last step).  With lam > 0 step k visits
    seq[k] for k < mu + lam, else seq[mu + (k - mu) % lam]; lam = 0: no
    row repeated within ``steps`` and mu = steps."""
    seq, first = [], {}
    r = 1
    for k in range(int(steps)):
        if r in first:
            mu = first[r]
            lam = k - mu
            return seq, mu, lam, seq[mu + (steps - mu) % lam]
        first[r] = k
        seq.append(r)
        r = nxt[r]
    return seq, int(steps), 0, r


WRAPPERS = (packet_slab_chase, step_attrib, step_attrib_chain, step_ablate)
KERNELS = tuple(k for w in WRAPPERS for k in w.launches)


def launch_counts() -> dict:
    """Kernel launches by kernel name, over all the wrappers."""
    return {k: v for w in WRAPPERS for k, v in w.launches.items()}


def reset_launches():
    for w in WRAPPERS:
        w.launches = dict.fromkeys(w.launches, 0)
