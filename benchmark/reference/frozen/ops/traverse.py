"""BVH8 traversal, plain torch only (frozen copy of the port's
``ops/traverse.py`` without its CUDA kernels, wrapper and ray sort).

``traverse_raw`` runs ``traverse_raw_plain`` on every device: a lock-step
closest-hit traversal with per-lane any-hit, one node visit per lane and
step.  The ray order does not change the result, so the rays are traced
in the order given.  ``traverse_raw_plain`` can also record the rows it
reads (``touched``), which the benchmark's traversal bound counts.
"""

from __future__ import annotations

import dataclasses

import torch

# Lock-step steps between the plain version's any-lane-active checks
# (each check is a device-to-host sync on CUDA).
TRAVERSE_CHUNK = 8


@dataclasses.dataclass(frozen=True)
class TraverseConfig:
    """The leaf test the rows are packed for and the winner among equal t
    in a leaf.  The frozen copy reads no environment flags."""

    kernel: str = "v1"
    leaf: str = "watertight"
    winner: str = "slot"

    def __post_init__(self):
        for name, allowed in (("kernel", ("v1", "v2")), ("leaf", ("watertight", "mt")),
                              ("winner", ("slot", "min"))):
            if getattr(self, name) not in allowed:
                raise ValueError(f"{name}={getattr(self, name)!r}: expected one of {allowed}")


V1 = TraverseConfig("v1", "watertight", "slot")


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


def _popcount8(v):
    """Popcount of a value in [0, 255]."""
    v = v - ((v >> 1) & 0x55)
    v = (v & 0x33) + ((v >> 2) & 0x33)
    return (v + (v >> 4)) & 0x0F


def traverse_raw(tris, ray_o, ray_d, t_max, any_hit=False, sort_rays=True,
                 return_steps=False):
    """Closest-hit traversal with per-lane any-hit: returns (t, tri[, steps])
    with t = +inf and tri = -1 on a miss, by ``traverse_raw_plain`` on the
    rays' own device.  ``sort_rays`` is accepted for the callers' signature
    and ignored."""
    n = ray_o.shape[0]
    dev = ray_o.device
    for name, x in (("ray_o", ray_o), ("ray_d", ray_d), ("t_max", t_max)):
        if isinstance(x, torch.Tensor) and x.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {x.dtype}, expected torch.float32")
    t_max = torch.broadcast_to(
        torch.as_tensor(t_max, dtype=torch.float32, device=dev), (n,)
    ).contiguous()
    want = torch.broadcast_to(
        torch.as_tensor(any_hit, dtype=torch.bool, device=dev), (n,)
    ).contiguous()
    t, tri, steps = traverse_raw_plain(
        tris.rows8, tris.stack_depth, ray_o.contiguous(), ray_d.contiguous(), t_max, want,
        return_steps=True, leaf=tris.traverse.leaf, winner=tris.traverse.winner,
    )
    t = torch.where(tri >= 0, t, torch.inf)
    return (t, tri, steps) if return_steps else (t, tri)


def traverse_raw_plain(rows8, stack_depth, ray_o, ray_d, t_max, any_hit,
                       return_steps=False, leaf="watertight", winner="slot", touched=None):
    """Plain torch version of the kernels (v1 and v2 compute the same
    function): a lock-step port of the reference's XLA bitstack traversal
    (``shapes/triangle.py::_traverse``, raw mode).  Every lane advances one
    node visit per step and each step gathers one (N, 128) row per lane.
    Internal visits descend into the nearest hit child and push the
    remainders with conservative entry distances; popped groups beyond the
    current best are pruned.  ``leaf`` is the leaf test the rows are packed
    for ("watertight" or "mt"); ``winner`` picks among equal t in a leaf
    ("slot": the lowest slot, "min": the lowest triangle id).  Returns
    (t, tri[, steps]) with t = +inf where tri = -1.  ``touched``, a zeroed
    (R,) bool tensor or None, is set at every row a live lane visits."""
    from benchmark.reference.frozen.shapes.triangle import intersect_triangle, intersect_triangle_mt

    if leaf not in ("watertight", "mt") or winner not in ("slot", "min"):
        raise ValueError(f"unknown leaf test {leaf!r} or winner {winner!r}")
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
        if touched is not None:
            touched[row_idx[active].long()] = True
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

