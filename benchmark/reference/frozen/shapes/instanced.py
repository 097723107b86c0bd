"""Two-level BVH for instanced geometry, pbrt-v4's ``ObjectInstance``
(port of ``shimmer_tpu/shapes/instanced.py``).

Each object (the shapes between ``ObjectBegin`` and ``ObjectEnd``) gets one
BVH8 in object space; a top BVH8 over the instances' world bounds picks
instances.  Entering an instance maps the lane's ray into object space
(affine, so ``t`` is unchanged: the direction is not renormalized) and
pushes a restore marker; popping the marker maps the lane back to world
space.  N instances of a T-triangle object cost one object BVH and N
instance-entry rows, not N * T triangles.

Layout (rows of ``ops/bvh8.py``): the combined row table is [top tree +
instance-entry rows | object trees], the object blocks' child bases and
leaf triangle ids offset at pack time.  An instance-entry row has col 80 =
9, col 48 = the object's root row and col 72 = the instance id; it is
reached only as a child slot of a top-tree row whose boxes are the
instances' world bounds.  Row indices and triangle ids are stored as
float32 and are exact up to 2^24.

The traversal is the reference's lock-step loop as plain tensor code on
the lanes' device (the reference runs it as a ``lax.while_loop``, not a
Pallas kernel): the same step (pop, restore marker, slab test, watertight
leaf test, instance entry, pushes), lowest set bit first, and the same
test for a live lane once every ``TRAVERSE_CHUNK`` steps, which is one
host sync per chunk.  At each chunk boundary the lanes that are done leave
the working set; a finished lane's state never changes in the reference's
loop either (every write is masked by its activity), so results are the
same.  Area lights inside objects are refused, as the reference refuses
them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference.frozen.config import f32, resolve_device
from benchmark.reference.frozen.ops.bvh8 import MAX_LEAF8, build_bvh8, pack_bvh8
from benchmark.reference.frozen.ops.math import dot_lanes, stop_gradient
from benchmark.reference.frozen.shapes.triangle import (
    _attr_for,
    _concat_meshes,
    _popcount8,
    build_triangle_interaction,
    intersect_triangle,
)

_INST_SENTINEL = 9   # col-80 value of an instance-entry row
_MARKER = -1         # stack entry: restore the lane to world space

TRAVERSE_CHUNK = 8


@dataclasses.dataclass(frozen=True)
class InstancedTriangles:
    rows8: torch.Tensor      # (R, 128) combined row table
    attr_rows: torch.Tensor  # (T_total, 32) BVH-order attributes, objects concatenated
    inst_inv: torch.Tensor   # (I, 12) world -> object affine (row-major 3x4)
    inst_fwd: torch.Tensor   # (I, 12) object -> world affine
    world_min: torch.Tensor  # (3,)
    world_max: torch.Tensor  # (3,)
    stack_depth: int = 24
    has_normals: bool = False
    has_uv: bool = False


def _affine12(m4: np.ndarray) -> np.ndarray:
    return np.asarray(m4, np.float64)[:3, :4].astype(np.float32).reshape(12)


def _apply12(a12, p, w: float = 1.0):
    """Per-lane (..., 12) row-major 3x4 affines applied to (..., 3) points
    (w = 1) or vectors (w = 0): the batched product added as the
    reference's CPU contraction adds it (``dot_lanes``), then ``w`` times
    the translation."""
    m = a12.reshape(a12.shape[:-1] + (3, 4))
    rows = [dot_lanes([(m[..., i, j], p[..., j]) for j in range(3)]) + w * m[..., i, 3]
            for i in range(3)]
    return torch.stack(rows, dim=-1)


def _apply_transposed(a12, v):
    """The transposed 3x3 part of per-lane affines applied to (..., 3)
    vectors: out[i] = sum_j m[j, i] v[j]; a normal maps by the inverse
    transpose, so this takes the world -> object affine."""
    m = a12.reshape(a12.shape[:-1] + (3, 4))
    return torch.stack([dot_lanes([(m[..., j, i], v[..., j]) for j in range(3)])
                        for i in range(3)], dim=-1)


def _pack_object(meshes: list[dict]) -> dict:
    """One object's BVH8 and attribute rows, in object space."""
    cat = _concat_meshes(meshes)
    if (cat["area_light_id"] >= 0).any():
        raise NotImplementedError(
            "area lights inside an object instance are not supported (nor by the reference)")
    bvh8 = pack_bvh8(cat["lo"], cat["hi"], cat["tri_p"])
    return {
        "rows": bvh8.rows,
        "attr": _attr_for(cat, bvh8.perm),
        "max_depth": bvh8.max_depth,
        "lo": cat["lo"].min(axis=0),
        "hi": cat["hi"].max(axis=0),
        "has_normals": cat["has_normals"],
        "has_uv": cat["has_uv"],
    }


def build_instanced(objects: list[list[dict]], instances: list[tuple[int, np.ndarray]],
                    device=None) -> InstancedTriangles:
    """Host build.  ``objects``: per object, its mesh dicts in object
    space; ``instances``: (object id, object-to-render 4x4 matrix) pairs.
    Tables move to ``device`` (default: the CUDA card)."""
    device = resolve_device(device)
    obj_packed = [_pack_object(m) for m in objects]

    n_inst = len(instances)
    inst_lo = np.zeros((n_inst, 3), np.float32)
    inst_hi = np.zeros((n_inst, 3), np.float32)
    inst_fwd = np.zeros((n_inst, 12), np.float32)
    inst_inv = np.zeros((n_inst, 12), np.float32)
    for i, (oid, o2r) in enumerate(instances):
        lo, hi = obj_packed[oid]["lo"], obj_packed[oid]["hi"]
        cs = np.array([[x, y, z, 1.0] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
                       for z in (lo[2], hi[2])])
        m = np.asarray(o2r, np.float64)
        w = (m @ cs.T).T
        w = w[:, :3] / w[:, 3:4]
        inst_lo[i] = w.min(axis=0).astype(np.float32)
        inst_hi[i] = w.max(axis=0).astype(np.float32)
        inst_fwd[i] = _affine12(m)
        inst_inv[i] = _affine12(np.linalg.inv(m))

    top_arrs, top_leaf_rows = build_bvh8(inst_lo, inst_hi, builder="lbvh")
    rows_top = top_arrs.rows.copy()
    n_top = top_arrs.n_rows
    perm = top_arrs.perm
    # Each top leaf row (count perm-ordered instances) becomes an internal
    # row whose children are instance-entry rows.
    entry = []   # (row, instance id)
    next_row = n_top
    for (r, first, count, _s) in top_leaf_rows:
        base = next_row
        rows_top[r, :] = 0.0
        rows_top[r, 48] = float(base)
        for j in range(count):
            inst = int(perm[first + j])
            rows_top[r, 0 + j] = inst_lo[inst, 0]
            rows_top[r, 8 + j] = inst_lo[inst, 1]
            rows_top[r, 16 + j] = inst_lo[inst, 2]
            rows_top[r, 24 + j] = inst_hi[inst, 0]
            rows_top[r, 32 + j] = inst_hi[inst, 1]
            rows_top[r, 40 + j] = inst_hi[inst, 2]
            rows_top[r, 88 + j] = 1.0
            entry.append((base + j, inst))
            next_row += 1

    rows0 = np.zeros((next_row, 128), np.float32)
    rows0[:n_top] = rows_top
    for er, inst in entry:
        rows0[er, 80] = float(_INST_SENTINEL)
        rows0[er, 72] = float(inst)

    # The object blocks, with their row and triangle offsets.
    blocks, attr_all, obj_root_abs = [rows0], [], []
    row_off, tri_off, max_obj_depth = next_row, 0, 0
    for packed in obj_packed:
        orows = packed["rows"].copy()
        orows[orows[:, 80] == 0.0, 48] += row_off
        is_leaf = orows[:, 80] > 0.0
        for k in range(MAX_LEAF8):
            orows[is_leaf, 72 + k] += tri_off
        blocks.append(orows)
        attr_all.append(packed["attr"])
        obj_root_abs.append(row_off)
        row_off += orows.shape[0]
        tri_off += packed["attr"].shape[0]
        max_obj_depth = max(max_obj_depth, packed["max_depth"])
    rows = np.concatenate(blocks, axis=0)
    for er, inst in entry:
        rows[er, 48] = float(obj_root_abs[instances[inst][0]])

    return InstancedTriangles(
        rows8=f32(rows, device),
        attr_rows=f32(np.concatenate(attr_all, axis=0), device),
        inst_inv=f32(inst_inv, device),
        inst_fwd=f32(inst_fwd, device),
        world_min=f32(inst_lo.min(axis=0), device),
        world_max=f32(inst_hi.max(axis=0), device),
        stack_depth=int(top_arrs.max_depth) + max_obj_depth + 4,
        has_normals=any(p["has_normals"] for p in obj_packed),
        has_uv=any(p["has_uv"] for p in obj_packed),
    )


def _lane_active(s):
    alive = ((s["group"] & 255) > 0) | (s["sp"] > 0)
    return alive & ~(s["want_any"] & (s["tri_best"] >= 0))


def _step(data: InstancedTriangles, s: dict):
    """One lock-step traversal step over the working lanes (in place)."""
    dev = s["group"].device
    lane8 = torch.arange(MAX_LEAF8, dtype=torch.int32, device=dev)
    bit_pow = torch.bitwise_left_shift(torch.ones_like(lane8), lane8)
    depth = s["stack"].shape[1]
    group, sp, stack, t_best = s["group"], s["sp"], s["stack"], s["t_best"]
    o_cur, d_cur, inst_cur = s["o_cur"], s["d_cur"], s["inst_cur"]

    active = _lane_active(s)

    # Pop when the current group is empty; a marker restores world space.
    need_pop = active & ((group & 255) == 0)
    sp_p = sp - need_pop.to(torch.int32)
    popped = torch.gather(stack, 1, torch.clamp(sp_p, 0, depth - 1).long()[:, None])[:, 0]
    is_marker = need_pop & (popped == _MARKER)
    o_cur = torch.where(is_marker[:, None], s["ray_o"], o_cur)
    d_cur = torch.where(is_marker[:, None], s["ray_d"], d_cur)
    inst_cur = torch.where(is_marker, -1, inst_cur)
    group = torch.where(need_pop, torch.where(is_marker, 0, popped), group)
    sp = sp_p
    active = active & ~is_marker

    inv_cur = 1.0 / torch.where(d_cur == 0.0, torch.full_like(d_cur, 1e-30), d_cur)

    mask = group & 255
    t_low = mask & -mask
    k = _popcount8(t_low - 1)
    group_rem = group - t_low
    row_idx = torch.where(active, (group >> 8) + k, 0)
    row = data.rows8[row_idx.long()]

    count = row[:, 80].to(torch.int32)
    is_leaf = active & (count > 0) & (count <= MAX_LEAF8)
    is_int = active & (count == 0)
    is_inst = active & (count == _INST_SENTINEL)

    # Internal row: slab test in the lane's current space.
    ox, oy, oz = o_cur[:, 0:1], o_cur[:, 1:2], o_cur[:, 2:3]
    ix, iy, iz = inv_cur[:, 0:1], inv_cur[:, 1:2], inv_cur[:, 2:3]
    t0x = (row[:, 0:8] - ox) * ix
    t1x = (row[:, 24:32] - ox) * ix
    t0y = (row[:, 8:16] - oy) * iy
    t1y = (row[:, 32:40] - oy) * iy
    t0z = (row[:, 16:24] - oz) * iz
    t1z = (row[:, 40:48] - oz) * iz
    t_near = torch.maximum(torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
                           torch.minimum(t0z, t1z))
    t_far = torch.minimum(torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
                          torch.maximum(t0z, t1z))
    hit8 = ((t_near <= t_far * 1.0001) & (t_far > 0.0) & (t_near < t_best[:, None])
            & (row[:, 88:96] > 0.0) & is_int[:, None])
    hmask = torch.sum(torch.where(hit8, bit_pow, 0), dim=1, dtype=torch.int32)
    child_group = (row[:, 48].to(torch.int32) << 8) | hmask

    # Leaf row: watertight test in the current space (t is invariant under
    # the affine map, the direction being unnormalized).
    p0 = torch.stack([row[:, 0:8], row[:, 8:16], row[:, 16:24]], dim=-1)
    p1 = torch.stack([row[:, 24:32], row[:, 32:40], row[:, 40:48]], dim=-1)
    p2 = torch.stack([row[:, 48:56], row[:, 56:64], row[:, 64:72]], dim=-1)
    h, t, bb0, bb1, _ = intersect_triangle(o_cur[:, None, :], d_cur[:, None, :],
                                           t_best[:, None], p0, p1, p2)
    in_leaf = is_leaf[:, None] & (lane8[None, :] < count[:, None])
    t = torch.where(h & in_leaf, t, torch.inf)
    k_best = torch.argmin(t, dim=-1)
    oh = lane8[None, :] == k_best[:, None].to(torch.int32)
    t_new = torch.min(t, dim=-1).values
    closer = t_new < t_best

    def pick(x):
        return torch.sum(torch.where(oh, x, 0.0), dim=-1)

    s["t_best"] = torch.where(closer, t_new, t_best)
    s["tri_best"] = torch.where(closer, pick(row[:, 72:80]).to(torch.int32), s["tri_best"])
    s["inst_best"] = torch.where(closer, inst_cur, s["inst_best"])
    s["b0"] = torch.where(closer, pick(bb0), s["b0"])
    s["b1"] = torch.where(closer, pick(bb1), s["b1"])
    verts_new = torch.cat([torch.sum(torch.where(oh[:, :, None], v, 0.0), dim=1)
                           for v in (p0, p1, p2)], dim=-1)
    s["verts"] = torch.where(closer[:, None], verts_new, s["verts"])

    # Instance entry: the ray into object space, a restore marker pushed.
    inst_id = row[:, 72].to(torch.int32)
    inv12 = data.inst_inv[torch.where(is_inst, inst_id, 0).long()]
    o_cur = torch.where(is_inst[:, None], _apply12(inv12, s["ray_o"], 1.0), o_cur)
    d_cur = torch.where(is_inst[:, None], _apply12(inv12, s["ray_d"], 0.0), d_cur)
    inst_cur = torch.where(is_inst, inst_id, inst_cur)
    root_group = (row[:, 48].to(torch.int32) << 8) | 1

    # An internal row descends into its hit children as one group; an
    # instance pushes the rest of its group, then a marker, and descends
    # into the object's root.
    descend_int = is_int & (hmask > 0)
    push_rem = (descend_int | is_inst) & ((group_rem & 255) > 0)
    for pos, value, push in ((sp, group_rem, push_rem),
                             (sp + push_rem.to(torch.int32), torch.full_like(sp, _MARKER),
                              is_inst)):
        at = torch.clamp(pos, 0, depth - 1).long()[:, None]
        write = push & (pos < depth)
        cur = torch.gather(stack, 1, at)[:, 0]
        stack.scatter_(1, at, torch.where(write, value, cur)[:, None])
    sp = sp + push_rem.to(torch.int32) + is_inst.to(torch.int32)
    group_next = torch.where(is_inst, root_group,
                             torch.where(descend_int, child_group, group_rem))
    s["group"] = torch.where(active, group_next, group)
    s["sp"], s["o_cur"], s["d_cur"], s["inst_cur"] = sp, o_cur, d_cur, inst_cur


_OUTPUTS = ("t_best", "tri_best", "b0", "b1", "verts", "inst_best")


def _traverse_inst(data: InstancedTriangles, ray_o, ray_d, t_max, any_hit=False):
    """Two-level lock-step traversal.  Returns (t, tri, b0, b1, b2,
    verts_obj (N, 9), inst) with t = inf and tri = -1 on a miss.  When
    ``_traverse_inst.steps`` is a list, each call appends its step count."""
    n, dev = ray_o.shape[0], ray_o.device
    depth = data.stack_depth + 2
    t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=dev), (n,))
    s = {
        "group": torch.ones(n, dtype=torch.int32, device=dev),   # row 0, mask 1
        "sp": torch.zeros(n, dtype=torch.int32, device=dev),
        "stack": torch.zeros((n, depth), dtype=torch.int32, device=dev),
        "t_best": t_max.clone(),
        "tri_best": torch.full((n,), -1, dtype=torch.int32, device=dev),
        "b0": torch.zeros(n, device=dev),
        "b1": torch.zeros(n, device=dev),
        "verts": torch.zeros((n, 9), device=dev),
        "o_cur": ray_o,
        "d_cur": ray_d,
        "inst_cur": torch.full((n,), -1, dtype=torch.int32, device=dev),
        "inst_best": torch.full((n,), -1, dtype=torch.int32, device=dev),
        "ray_o": ray_o,
        "ray_d": ray_d,
        "want_any": torch.broadcast_to(torch.as_tensor(any_hit, device=dev), (n,)),
    }
    out = {k: s[k].clone() for k in _OUTPUTS}
    lanes = torch.arange(n, device=dev)
    steps = 0
    while True:
        # Every working lane's outputs so far (a lane that is done leaves
        # the working set with its final values written).
        for k in _OUTPUTS:
            out[k][lanes] = s[k]
        keep = torch.nonzero(_lane_active(s))[:, 0]   # the chunk's one host sync
        if keep.numel() == 0:
            break
        if keep.numel() < lanes.numel():
            s = {k: v[keep] for k, v in s.items()}
            lanes = lanes[keep]
        for _ in range(TRAVERSE_CHUNK):
            _step(data, s)
        steps += TRAVERSE_CHUNK
    if isinstance(_traverse_inst.steps, list):
        _traverse_inst.steps.append(steps)
    hit = out["tri_best"] >= 0
    b2 = torch.where(hit, 1.0 - out["b0"] - out["b1"], 0.0)
    t = torch.where(hit, out["t_best"], torch.inf)
    return t, out["tri_best"], out["b0"], out["b1"], b2, out["verts"], out["inst_best"]


_traverse_inst.steps = None


def instanced_intersect(data: InstancedTriangles, ray_o, ray_d, t_max, want_any=False):
    """Closest hit against the instanced geometry, as an interaction in
    world space.  Lanes flagged in ``want_any`` stop at their first
    accepted hit (only ``valid`` means anything there)."""
    t, tri, b0, b1, b2, verts_obj, inst = _traverse_inst(
        data, stop_gradient(ray_o), stop_gradient(ray_d), stop_gradient(t_max),
        any_hit=want_any)
    inst_c = torch.clamp(inst, min=0).long()
    fwd = data.inst_fwd[inst_c]
    p0 = _apply12(fwd, verts_obj[..., 0:3], 1.0)
    p1 = _apply12(fwd, verts_obj[..., 3:6], 1.0)
    p2 = _apply12(fwd, verts_obj[..., 6:9], 1.0)
    inv = data.inst_inv[inst_c]
    attr = data.attr_rows[torch.clamp(tri, min=0).long()]
    return build_triangle_interaction(
        data.has_normals, ray_d, t, tri, b0, b1, b2, p0, p1, p2, attr,
        ns_transform=lambda ns: _apply_transposed(inv, ns),
    )


def instanced_occluded(data: InstancedTriangles, ray_o, ray_d, t_max):
    _, tri, *_ = _traverse_inst(data, stop_gradient(ray_o), stop_gradient(ray_d),
                                stop_gradient(t_max), any_hit=True)
    return tri >= 0
