"""BVH8 traversal: the hand-written CUDA kernels, their wrapper, and their
plain torch version.

Replaces the reference's packet traversal
(``shimmer_tpu/ops/pallas/traverse.py``: ``_traverse_kernel`` with its
streamed, Moller-Trumbore and min-winner forms, ``_traverse_kernel_v2``,
and the glue of ``traverse_packets_raw``).  :class:`TraverseConfig` picks
the form.  One CUDA source, ``csrc/traverse.cu``, holds both kernels
behind one C entry point:

* v1 (``csrc/traverse_body.cuh``): one ray per thread with a stack of
  ``child_base << 8 | pending bits`` entries, as templates over the leaf
  test (watertight or Moller-Trumbore) and the winner among equal t in a
  leaf (lowest slot or lowest id);
* v2 (``csrc/traverse_v2_body.cuh``): ordered near-first internal pops
  plus a postponed-leaf backlog; it reads whether a hit child is a leaf
  from its parent's word of :func:`child_leaf_mask`.

On the H100 both are bound by chains of dependent row reads and warp
divergence, not by FLOPs; the row table is read through the read-only
path and, at the bench size (39 MB), stays in the 50 MB L2.  The rays are
sorted by origin/direction keys before the launch, on by default as in
the reference, where the sort grouped rays into coherent packets.  For a
per-ray kernel it does not pay on an H100: bounce and shadow batches in
pixel order trace faster unsorted, and the argsort costs more than the
launch (PERF.md); the default stays until a benchmark decides.

``traverse_raw`` dispatches on the rays' device: CUDA tensors launch the
kernel of the scene's configuration or raise; CPU tensors run
``traverse_raw_plain``, a lock-step port of the reference's XLA bitstack
traversal (``shapes/triangle.py::_traverse`` in raw mode) with the
configuration's leaf test and winner.  Nothing falls back from CUDA to the
plain version.

The kernel library ``traverse`` is built at first use from the sources
in ``csrc/`` by the port's shared nvcc build (``ops/cuda_build.py``) into
``shimmer_tpu_torch/_build/``, and rebuilt when a source is newer than it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import threading

import torch

from shimmer_tpu_torch.ops import cuda_build

# Per-thread internal stack entries in the kernels (traverse_body.cuh
# kMaxStack).
KERNEL_MAX_STACK = 64
# Leaf backlog entries of the v2 kernel (traverse_v2_body.cuh kLeafStack,
# the reference's LEAF_STACK).
LEAF_STACK = 32
# Rays per traversal packet in the reference; batches up to this size are
# not sorted (the reference skips the sort there too).
SORT_MIN_RAYS = 128
# Lock-step steps between the plain version's any-lane-active checks
# (each check is a device-to-host sync on CUDA).
TRAVERSE_CHUNK = 8

_lock = threading.Lock()
_lib = None


def _env_kernel() -> str:
    return "v1" if os.environ.get("SHIMMER_KERNEL_V1", "1") == "1" else "v2"


def _env_leaf() -> str:
    return "mt" if os.environ.get("SHIMMER_LEAF_MT", "0") == "1" else "watertight"


def _env_winner() -> str:
    return "min" if os.environ.get("SHIMMER_WINID_MIN", "0") == "1" else "slot"


@dataclasses.dataclass(frozen=True)
class TraverseConfig:
    """Which traversal runs.  Defaults follow the reference's environment
    flags, read when the config is made: ``SHIMMER_KERNEL_V1`` (``"0"`` ->
    v2), ``SHIMMER_LEAF_MT`` (``"1"`` -> Moller-Trumbore leaves) and
    ``SHIMMER_WINID_MIN`` (``"1"`` -> lowest id wins among equal t).

    The leaf layout of ``rows8`` is fixed when the table is packed, so the
    config lives on ``TriangleSceneData``.  MT leaves and the min-id winner
    run only under v1: with ``kernel="v2"`` they raise (the reference
    silently pins v1 for MT leaves and runs v2 with the slot winner)."""

    kernel: str = dataclasses.field(default_factory=_env_kernel)
    leaf: str = dataclasses.field(default_factory=_env_leaf)
    winner: str = dataclasses.field(default_factory=_env_winner)

    def __post_init__(self):
        for name, allowed in (("kernel", ("v1", "v2")), ("leaf", ("watertight", "mt")),
                              ("winner", ("slot", "min"))):
            if getattr(self, name) not in allowed:
                raise ValueError(f"{name}={getattr(self, name)!r}: expected one of {allowed}")
        if self.kernel == "v2" and self.leaf == "mt":
            raise ValueError("Moller-Trumbore leaves run only under kernel='v1'")
        if self.kernel == "v2" and self.winner == "min":
            raise ValueError("the min-id winner runs only under kernel='v1'")

    @property
    def name(self) -> str:
        """The launch-counter key: v1, v1_mt, v1_min, v1_mt_min, v2."""
        return "_".join(
            [self.kernel] + (["mt"] if self.leaf == "mt" else [])
            + (["min"] if self.winner == "min" else [])
        )


V1 = TraverseConfig("v1", "watertight", "slot")
KERNEL_NAMES = ("v1", "v1_mt", "v1_min", "v1_mt_min", "v2")


def _launcher():
    """The ``traverse`` library with its C signatures, built and loaded at
    first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = cuda_build.load("traverse")
            p, ci = ctypes.c_void_p, ctypes.c_int
            lib.shimmer_traverse_launch.argtypes = [ci, ci, ci, p, p, p, ci, p, p, p, p, p, p,
                                                    p, p, ci, p]
            lib.shimmer_traverse_launch.restype = ci
            lib.shimmer_traverse_blocks_per_sm.argtypes = [ci, ci, ci]
            lib.shimmer_traverse_blocks_per_sm.restype = ci
            lib.shimmer_traverse_max_stack.argtypes = []
            lib.shimmer_traverse_max_stack.restype = ci
            if lib.shimmer_traverse_max_stack() != KERNEL_MAX_STACK:
                raise cuda_build.KernelBuildError("kernel stack bound disagrees with the wrapper")
            _lib = lib
        return _lib


def _kernel_args(config: TraverseConfig) -> tuple[int, int, int]:
    """The C entry points' (kernel, leaf, winner) of a configuration."""
    return (1 if config.kernel == "v1" else 2, int(config.leaf == "mt"),
            int(config.winner == "min"))


def blocks_per_sm(config: TraverseConfig) -> int:
    """Resident blocks per SM of the kernel of ``config``, from the CUDA
    occupancy calculator."""
    return _launcher().shimmer_traverse_blocks_per_sm(*_kernel_args(config))


def child_leaf_mask(meta):
    """The (R,) int32 child-leaf words of a table's ``meta``: for an
    internal row, bit j set when its child row ``child_base + j`` (clamped
    into the table) is a leaf; 0 for a leaf row.  The reference packs the
    same mask into tiles8 column c11 (``shimmer_tpu/ops/bvh8.py::
    pack_tiles8``) for its v2 kernel, which splits a visit's hit children
    into internal entries and leaf-backlog bits without reading their meta
    words; the port's v2 kernel reads one such word per internal visit."""
    n_rows = meta.shape[0]
    child = torch.clamp((meta.long() >> 4)[:, None] + torch.arange(8, device=meta.device),
                        0, max(n_rows - 1, 0))
    is_leaf = (meta[child] & 15) > 0
    mask = (is_leaf.long() << torch.arange(8, device=meta.device)).sum(1)
    return torch.where((meta & 15) == 0, mask, 0).to(torch.int32)


def _launch_kernel(rows8, meta, stack_depth, o, d, t_max, any_hit, return_steps,
                   config: TraverseConfig = V1, touched=None, child_leaf=None):
    """Launch the CUDA kernel of ``config`` on (N,) rays already laid out
    for it.  Returns (t, tri, steps or None); t = +inf where tri = -1.

    ``touched``, a zeroed (2 * R,) uint8 tensor or None, records what the
    launch reads: 1 at ``touched[r]`` for each row visited and at
    ``touched[R + r]`` for each meta word read (the work behind the
    launch's bound; csrc/traverse_body.cuh, touch_row).  ``child_leaf``,
    the table's :func:`child_leaf_mask`, is required by v2 and ignored by
    v1."""
    dev = o.device
    n = o.shape[0]
    n_rows = rows8.shape[0]
    cuda_build.check_tensor("rows8", rows8, torch.float32, (n_rows, 128), dev)
    cuda_build.check_tensor("meta", meta, torch.int32, (n_rows,), dev)
    cuda_build.check_tensor("o", o, torch.float32, (n, 3), dev)
    cuda_build.check_tensor("d", d, torch.float32, (n, 3), dev)
    cuda_build.check_tensor("t_max", t_max, torch.float32, (n,), dev)
    cuda_build.check_tensor("any_hit", any_hit, torch.bool, (n,), dev)
    if config.kernel == "v2":
        if child_leaf is None:
            raise ValueError("the v2 kernel needs the table's child_leaf_mask")
        cuda_build.check_tensor("child_leaf", child_leaf, torch.int32, (n_rows,), dev)
    if rows8.data_ptr() % 16:
        raise ValueError("rows8 must be 16-byte aligned: the kernels read it in 16-byte loads")
    if int(stack_depth) + 8 > KERNEL_MAX_STACK:
        raise ValueError(
            f"BVH needs a stack of {int(stack_depth) + 8} entries; the kernel "
            f"holds {KERNEL_MAX_STACK}"
        )
    if touched is not None:
        cuda_build.check_tensor("touched", touched, torch.uint8, (2 * n_rows,), dev)
    if n_rows == 0:
        raise ValueError("empty BVH table")
    launch = _launcher().shimmer_traverse_launch
    t = torch.empty(n, dtype=torch.float32, device=dev)
    tri = torch.empty(n, dtype=torch.int32, device=dev)
    steps = torch.empty(n, dtype=torch.int32, device=dev) if return_steps else None
    flags = any_hit.view(torch.uint8)
    err = launch(
        *_kernel_args(config), rows8.data_ptr(), meta.data_ptr(),
        child_leaf.data_ptr() if config.kernel == "v2" else None, n_rows, o.data_ptr(),
        d.data_ptr(), t_max.data_ptr(), flags.data_ptr(), t.data_ptr(), tri.data_ptr(),
        steps.data_ptr() if steps is not None else None,
        touched.data_ptr() if touched is not None else None, n,
        cuda_build.stream_of(o),
    )
    cuda_build.raise_on_error(err, f"traversal kernel {config.name}")
    traverse_raw.launches[config.name] += 1
    return t, tri, steps


def _popcount8(v):
    """Popcount of a value in [0, 255]."""
    v = v - ((v >> 1) & 0x55)
    v = (v & 0x33) + ((v >> 2) & 0x33)
    return (v + (v >> 4)) & 0x0F


def _part1by2(x):
    """Spread the low 10 bits of x so consecutive bits land 3 apart."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def ray_sort_keys(world_min, world_max, ray_o, ray_d, want_any):
    """Coherence sort keys (the reference's ``ray_sort_keys``): extension
    rays origin-Morton-major, then octant and coarse direction; shadow rays
    direction-major, with a flag bit above both classes."""
    ext = torch.clamp(world_max - world_min, min=1e-6)
    q = (ray_o - world_min[None, :]) / ext[None, :]
    q = torch.clamp((q * 64.0).to(torch.int32), 0, 63)
    morton = _part1by2(q[:, 0]) | (_part1by2(q[:, 1]) << 1) | (_part1by2(q[:, 2]) << 2)
    octant = (
        (ray_d[:, 0] < 0).to(torch.int32)
        + 2 * (ray_d[:, 1] < 0).to(torch.int32)
        + 4 * (ray_d[:, 2] < 0).to(torch.int32)
    )
    dq = torch.clamp(((ray_d + 1.0) * 2.0).to(torch.int32), 0, 3)
    fine = dq[:, 0] | (dq[:, 1] << 2) | (dq[:, 2] << 4)
    key_ext = (morton << 9) | (octant << 6) | fine
    key_sh = (octant << 27) | (fine << 21) | (morton << 3)
    return torch.where(want_any, (1 << 30) | key_sh, key_ext)


def ray_order(tris, ray_o, ray_d, t_max, want):
    """The permutation the wrapper traces rays in: sorted by
    ``ray_sort_keys``, dead lanes (t_max <= 0) last."""
    keys = torch.where(
        t_max > 0.0,
        ray_sort_keys(tris.world_min, tris.world_max, ray_o, ray_d, want),
        0x7FFFFFFF,
    )
    return torch.argsort(keys, stable=True)


def traverse_raw(tris, ray_o, ray_d, t_max, any_hit=False, sort_rays=True,
                 return_steps=False):
    """Closest-hit traversal with per-lane any-hit, in the original ray
    order: returns (t, tri[, steps]) with t = +inf and tri = -1 on a miss.

    tris: a ``TriangleSceneData`` (rows8, meta, child_leaf, stack_depth,
    world bounds, and the traversal configuration ``traverse``).
    t_max: scalar or (N,); lanes with t_max <= 0 are dead and miss.
    any_hit: bool or (N,) bool; those lanes stop at their first hit (only
    their occlusion bit is meaningful).
    """
    n = ray_o.shape[0]
    dev = ray_o.device
    for name, x in (("ray_o", ray_o), ("ray_d", ray_d), ("t_max", t_max)):
        if isinstance(x, torch.Tensor) and x.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {x.dtype}, expected torch.float32")
    ray_o = ray_o.contiguous()
    ray_d = ray_d.contiguous()
    t_max = torch.broadcast_to(
        torch.as_tensor(t_max, dtype=torch.float32, device=dev), (n,)
    ).contiguous()
    want = torch.broadcast_to(
        torch.as_tensor(any_hit, dtype=torch.bool, device=dev), (n,)
    ).contiguous()
    order = None
    if sort_rays and n > SORT_MIN_RAYS:
        order = ray_order(tris, ray_o, ray_d, t_max, want)
        ray_o, ray_d, t_max, want = ray_o[order], ray_d[order], t_max[order], want[order]
    if dev.type == "cuda":
        out = _launch_kernel(
            tris.rows8, tris.meta, tris.stack_depth, ray_o, ray_d, t_max, want,
            return_steps, tris.traverse, child_leaf=tris.child_leaf,
        )
    elif dev.type == "cpu":
        out = traverse_raw_plain(
            tris.rows8, tris.stack_depth, ray_o, ray_d, t_max, want,
            return_steps=True, leaf=tris.traverse.leaf, winner=tris.traverse.winner,
        )
    else:
        raise ValueError(f"no traversal for device {dev}")
    t, tri, steps = out
    if order is not None:
        t, tri, steps = (
            None if x is None else torch.empty_like(x).index_copy_(0, order, x)
            for x in (t, tri, steps)
        )
    t = torch.where(tri >= 0, t, torch.inf)
    return (t, tri, steps) if return_steps else (t, tri)


# Kernel launches by configuration name, counted where each is launched.
traverse_raw.launches = dict.fromkeys(KERNEL_NAMES, 0)


def traverse_raw_plain(rows8, stack_depth, ray_o, ray_d, t_max, any_hit,
                       return_steps=False, leaf="watertight", winner="slot"):
    """Plain torch version of the kernels (v1 and v2 compute the same
    function): a lock-step port of the reference's XLA bitstack traversal
    (``shapes/triangle.py::_traverse``, raw mode).  Every lane advances one
    node visit per step and each step gathers one (N, 128) row per lane.
    Internal visits descend into the nearest hit child and push the
    remainders with conservative entry distances; popped groups beyond the
    current best are pruned.  ``leaf`` is the leaf test the rows are packed
    for ("watertight" or "mt"); ``winner`` picks among equal t in a leaf
    ("slot": the lowest slot, "min": the lowest triangle id).  Returns
    (t, tri[, steps]) with t = +inf where tri = -1."""
    from shimmer_tpu_torch.shapes.triangle import intersect_triangle, intersect_triangle_mt

    if leaf not in ("watertight", "mt") or winner not in ("slot", "min"):
        raise ValueError(f"unknown leaf test {leaf!r} or winner {winner!r}")
    traverse_raw_plain.calls += 1
    dev = ray_o.device
    n = ray_o.shape[0]
    depth = int(stack_depth) + 2
    inv_d = 1.0 / torch.where(ray_d == 0.0, torch.full_like(ray_d, 1e-30), ray_d)
    want = torch.broadcast_to(torch.as_tensor(any_hit, device=dev), (n,))
    lane8 = torch.arange(8, dtype=torch.int32, device=dev)
    ids8 = torch.arange(72, 80, device=dev)
    bit_pow = torch.ones(8, dtype=torch.int32, device=dev) << lane8
    lane_idx = torch.arange(n, device=dev)

    group = torch.ones(n, dtype=torch.int32, device=dev)
    group_t = torch.zeros(n, dtype=torch.float32, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    stack = torch.zeros(n, depth, dtype=torch.int32, device=dev)
    stack_t = torch.zeros(n, depth, dtype=torch.float32, device=dev)
    t_best = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=dev), (n,)).clone()
    tri_best = torch.full((n,), -1, dtype=torch.int32, device=dev)
    visits = torch.zeros(n, dtype=torch.int32, device=dev)
    ox, oy, oz = ray_o[:, 0:1], ray_o[:, 1:2], ray_o[:, 2:3]
    ix, iy, iz = inv_d[:, 0:1], inv_d[:, 1:2], inv_d[:, 2:3]
    ro = ray_o[:, None, :]
    rd = ray_d[:, None, :]

    def lane_active():
        alive = ((group & 255) > 0) | (sp > 0)
        return alive & ~(want & (tri_best >= 0))

    def push(mask, pos, value, value_t):
        ok = mask & (pos < depth)
        pos = torch.clamp(pos, max=depth - 1)
        stack[lane_idx, pos] = torch.where(ok, value, stack[lane_idx, pos])
        stack_t[lane_idx, pos] = torch.where(ok, value_t, stack_t[lane_idx, pos])

    def step():
        nonlocal group, group_t, sp, t_best, tri_best, visits
        active = lane_active()
        need_pop = active & ((group & 255) == 0)
        sp_p = sp - need_pop.to(torch.int64)
        pos = torch.clamp(sp_p, 0, depth - 1)
        popped = torch.where(need_pop, stack[lane_idx, pos], 0)
        popped_t = torch.where(need_pop, stack_t[lane_idx, pos], 0.0)
        pruned = need_pop & (popped_t >= t_best)
        group = torch.where(need_pop, torch.where(pruned, 0, popped), group)
        group_t = torch.where(need_pop, popped_t, group_t)
        sp = sp_p
        active = active & ~pruned

        mask = group & 255
        t_low = mask & -mask
        k = _popcount8(t_low - 1)
        row_idx = torch.where(active, (group >> 8) + k, 0)
        group_rem = group - t_low
        row = rows8[row_idx.long()]
        visits = visits + active.to(torch.int32)

        count = row[:, 80].to(torch.int32)
        is_leaf = active & (count > 0)
        is_int = active & (count == 0)

        t0x = (row[:, 0:8] - ox) * ix
        t1x = (row[:, 24:32] - ox) * ix
        t0y = (row[:, 8:16] - oy) * iy
        t1y = (row[:, 32:40] - oy) * iy
        t0z = (row[:, 16:24] - oz) * iz
        t1z = (row[:, 40:48] - oz) * iz
        t_near = torch.maximum(
            torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
            torch.minimum(t0z, t1z),
        )
        t_far = torch.minimum(
            torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
            torch.maximum(t0z, t1z),
        )
        hit8 = (
            (t_near <= t_far * 1.0001)
            & (t_far > 0.0)
            & (t_near < t_best[:, None])
            & (row[:, 88:96] > 0.0)
            & is_int[:, None]
        )
        hmask = torch.sum(torch.where(hit8, bit_pow, 0), dim=1, dtype=torch.int32)
        child_base = row[:, 48].to(torch.int32)
        tn = torch.where(hit8, torch.clamp(t_near, min=0.0), torch.inf)
        k_near = torch.argmin(tn, dim=-1).to(torch.int32)
        near_t = torch.min(tn, dim=-1).values
        near_bit = torch.ones_like(k_near) << k_near
        child_rem = hmask & ~near_bit
        tn2 = torch.where(lane8[None, :] == k_near[:, None], torch.inf, tn)
        child_rem_t = torch.min(tn2, dim=-1).values
        child_group = ((child_base + k_near) << 8) | 1

        p0 = torch.stack([row[:, 0:8], row[:, 8:16], row[:, 16:24]], dim=-1)
        p1 = torch.stack([row[:, 24:32], row[:, 32:40], row[:, 40:48]], dim=-1)
        p2 = torch.stack([row[:, 48:56], row[:, 56:64], row[:, 64:72]], dim=-1)
        if leaf == "mt":  # the rows hold (p0, e1, e2)
            h, t = intersect_triangle_mt(ro, rd, t_best[:, None], p0, p1, p2)
        else:
            h, t, _, _, _ = intersect_triangle(ro, rd, t_best[:, None], p0, p1, p2)
        in_leaf = is_leaf[:, None] & (lane8[None, :] < count[:, None])
        t = torch.where(h & in_leaf, t, torch.inf)
        t_new = torch.min(t, dim=-1).values
        closer = t_new < t_best
        if winner == "min":
            ids = row[:, 72:80]
            win_id = torch.min(torch.where(t == t_new[:, None], ids, torch.inf), dim=-1).values
            win_id = torch.where(closer, win_id, 0.0).to(torch.int32)
        else:
            k_best = torch.argmin(t, dim=-1)
            win_id = row[lane_idx, ids8[k_best]].to(torch.int32)
        t_best = torch.where(closer, t_new, t_best)
        tri_best = torch.where(closer, win_id, tri_best)

        descend = is_int & (hmask > 0)
        push1 = descend & ((group_rem & 255) > 0)
        push2 = descend & (child_rem > 0)
        push(push1, sp, group_rem, group_t)
        push(push2, sp + push1.to(torch.int64), (child_base << 8) | child_rem, child_rem_t)
        sp = sp + push1.to(torch.int64) + push2.to(torch.int64)
        group_next = torch.where(descend, child_group, group_rem)
        group = torch.where(active, group_next, group)
        group_t = torch.where(descend, near_t, group_t)

    # Python loop in place of lax.while_loop: the any() test is one
    # device-to-host sync per chunk of lock-step steps.
    while bool(lane_active().any()):
        for _ in range(TRAVERSE_CHUNK):
            step()
    t_out = torch.where(tri_best >= 0, t_best, torch.inf)
    return (t_out, tri_best, visits) if return_steps else (t_out, tri_best)


traverse_raw_plain.calls = 0
