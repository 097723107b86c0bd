"""Triangle meshes: packed scene tables, watertight intersection, the
traversal entry and solid-angle light sampling (port of
``shimmer_tpu/shapes/triangle.py``: the triangle-only forward path).

The BVH8 build and row packing are the port's copies of the reference's
numpy code and native SAH builder (``ops/bvh8.py``, ``native/``), so both
packages traverse byte-identical ``rows8`` / ``meta`` tables.  The port keeps
``rows8`` (R, 128) f32 and ``meta`` (R,) i32 and drops ``tiles8``, the
TPU-only sublane repack of the same rows.  The traversal configuration
(``ops/traverse.py::TraverseConfig``) lives on the table, because the leaf
layout of ``rows8`` is fixed when it is packed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from shimmer_tpu_torch.config import f32, i32, resolve_device
from shimmer_tpu_torch.ops.bvh8 import pack_bvh8, pack_leaves_mt
from shimmer_tpu_torch.ops.math import difference_of_products
from shimmer_tpu_torch.ops.traverse import TraverseConfig, child_leaf_mask
from shimmer_tpu_torch.ops.sampling import (
    sample_spherical_triangle,
    sample_uniform_triangle,
)
from shimmer_tpu_torch.ops.vecmath import (
    coordinate_system,
    cross,
    distance_squared,
    dot,
    length,
    length_squared,
    normalize,
    spherical_triangle_area,
)
from shimmer_tpu_torch.shapes.interaction import SurfaceInteraction

MIN_SPHERICAL_SAMPLE_AREA = 3e-4
MAX_SPHERICAL_SAMPLE_AREA = 6.22

# Attribute-row columns (one (32,) f32 row per BVH-sorted triangle).
_ATTR_W = 32
_A_UV = 0        # 0:6   uv0, uv1, uv2
_A_NS = 6        # 6:15  n0, n1, n2 (zeros when the mesh has no normals)
_A_MAT = 15      # material id (may be -1)
_A_ALI = 16      # area light id (may be -1)
_A_REV = 17      # reverse_orientation flag (0/1)
_A_ORIG = 18     # original (pre-BVH-sort) triangle index
_A_P0 = 19       # 19:28 p0, p1, p2 render-space vertices
_A_MI = 28       # MediumInterface inside id (-2 = undeclared)
_A_MO = 29       # MediumInterface outside id

_LIGHT_W = 16    # light rows: 0:9 p0, p1, p2 | 9 reverse flag


@dataclasses.dataclass(frozen=True)
class TriangleSceneData:
    p: torch.Tensor             # (V, 3) render-space vertex pool
    n: torch.Tensor             # (V, 3) shading normals (zeros if absent)
    uv: torch.Tensor            # (V, 2)
    indices: torch.Tensor       # (T, 3) int32, BVH order
    orig_indices: torch.Tensor  # (T, 3) int32, original order
    orig_rev: torch.Tensor      # (T,) bool
    tri_area: torch.Tensor      # (T,)
    rows8: torch.Tensor         # (R, 128) f32, ops/bvh8.py layout
    meta: torch.Tensor          # (R,) int32 leaf_count | child_base << 4
    attr_rows: torch.Tensor     # (T, 32) f32, BVH order
    light_rows: torch.Tensor    # (T, 16) f32, original order
    world_min: torch.Tensor     # (3,)
    world_max: torch.Tensor     # (3,)
    stack_depth: int = 16
    has_normals: bool = False
    has_uv: bool = False
    has_iface_media: bool = False
    # Which traversal kernel runs and how leaf rows are packed.
    traverse: TraverseConfig = dataclasses.field(default_factory=TraverseConfig)
    # (R,) int32 child-leaf words the v2 kernel reads (child_leaf_mask of
    # meta), made from meta when not given.
    child_leaf: torch.Tensor | None = None

    def __post_init__(self):
        if self.child_leaf is None:
            object.__setattr__(self, "child_leaf", child_leaf_mask(self.meta))

    def with_traverse(self, traverse: TraverseConfig) -> "TriangleSceneData":
        """The same scene under another traversal configuration.  A
        watertight table repacks its leaf rows for ``leaf="mt"``; an MT
        table cannot go back (the edges are rounded)."""
        if traverse.leaf == self.traverse.leaf:
            return dataclasses.replace(self, traverse=traverse)
        if self.traverse.leaf != "watertight":
            raise ValueError("an MT-packed table cannot be unpacked; rebuild the scene")
        rows8 = pack_leaves_mt(self.rows8.cpu().numpy(), self.meta.cpu().numpy())
        return dataclasses.replace(
            self, rows8=f32(rows8, self.rows8.device), traverse=traverse
        )


def _concat_meshes(meshes: list[dict]) -> dict:
    """Concatenate mesh dicts into one SoA pool (+ per-triangle AABBs)."""
    ps, ns, uvs, idxs = [], [], [], []
    mats, ali, revs = [], [], []
    med_in, med_out = [], []
    v_off = 0
    any_n = any(m.get("n") is not None for m in meshes)
    any_uv = any(m.get("uv") is not None for m in meshes)
    for m in meshes:
        p = np.asarray(m["p"], np.float32)
        idx = np.asarray(m["indices"], np.int32).reshape(-1, 3)
        v, t = p.shape[0], idx.shape[0]
        ps.append(p)
        n = m.get("n")
        ns.append(np.asarray(n, np.float32) if n is not None else np.zeros((v, 3), np.float32))
        uv = m.get("uv")
        uvs.append(np.asarray(uv, np.float32) if uv is not None else np.zeros((v, 2), np.float32))
        idxs.append(idx + v_off)
        mats.append(np.full(t, m.get("material_id", -1), np.int32))
        med_in.append(np.full(t, m.get("medium_inside", -2), np.int32))
        med_out.append(np.full(t, m.get("medium_outside", -2), np.int32))
        a = m.get("area_light_id", -1)
        ali.append(np.asarray(a, np.int32) if np.ndim(a) > 0 else np.full(t, a, np.int32))
        revs.append(np.full(t, bool(m.get("reverse_orientation", False))))
        v_off += v
    p = np.concatenate(ps)
    indices = np.concatenate(idxs)
    tri_p = p[indices]
    return {
        "p": p,
        "n": np.concatenate(ns),
        "uv": np.concatenate(uvs),
        "indices": indices,
        "material_id": np.concatenate(mats),
        "medium_in": np.concatenate(med_in),
        "medium_out": np.concatenate(med_out),
        "area_light_id": np.concatenate(ali),
        "rev": np.concatenate(revs),
        "tri_p": tri_p,
        "lo": tri_p.min(axis=1),
        "hi": tri_p.max(axis=1),
        "has_normals": any_n,
        "has_uv": any_uv,
    }


def _attr_for(cat: dict, perm: np.ndarray) -> np.ndarray:
    """Per-triangle shading attribute rows in BVH (perm) order."""
    sorted_indices = cat["indices"][perm].astype(np.int32)
    t_n = sorted_indices.shape[0]
    attr = np.zeros((t_n, _ATTR_W), np.float32)
    tri_uv = cat["uv"][sorted_indices]
    no_uv = np.abs(tri_uv).sum(axis=(1, 2)) == 0.0
    tri_uv[no_uv] = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0]], np.float32)
    attr[:, _A_UV : _A_UV + 6] = tri_uv.reshape(t_n, 6)
    attr[:, _A_NS : _A_NS + 9] = cat["n"][sorted_indices].reshape(t_n, 9)
    attr[:, _A_MAT] = cat["material_id"][perm].astype(np.float32)
    attr[:, _A_ALI] = cat["area_light_id"][perm].astype(np.float32)
    attr[:, _A_REV] = cat["rev"][perm].astype(np.float32)
    attr[:, _A_ORIG] = perm.astype(np.float32)
    attr[:, _A_P0 : _A_P0 + 9] = cat["tri_p"][perm].reshape(t_n, 9)
    attr[:, _A_MI] = cat["medium_in"][perm].astype(np.float32)
    attr[:, _A_MO] = cat["medium_out"][perm].astype(np.float32)
    return attr


def build_triangle_scene(meshes: list[dict], device=None,
                         traverse: TraverseConfig | None = None) -> TriangleSceneData:
    """Host: concatenate meshes, build the BVH8, pack the tables, and move
    them to ``device`` (default: the CUDA card).  Mesh dicts as in the
    reference (``p``, ``indices``, optional ``n``, ``uv``, ``material_id``,
    ``area_light_id``, ``reverse_orientation``).  ``traverse`` defaults to
    ``TraverseConfig()`` (the reference's environment flags); ``leaf="mt"``
    packs the leaf rows as ``(p0, e1, e2)``."""
    device = resolve_device(device)
    traverse = TraverseConfig() if traverse is None else traverse
    cat = _concat_meshes(meshes)
    if (cat["medium_in"] > -2).any() or (cat["medium_out"] > -2).any():
        raise NotImplementedError("medium interfaces are not ported yet")
    indices, rev, tri_p = cat["indices"], cat["rev"], cat["tri_p"]
    lo, hi = cat["lo"], cat["hi"]
    bvh8 = pack_bvh8(lo, hi, tri_p)
    rows8 = pack_leaves_mt(bvh8.rows, bvh8.meta) if traverse.leaf == "mt" else bvh8.rows
    perm = bvh8.perm
    e1 = tri_p[:, 1] - tri_p[:, 0]
    e2 = tri_p[:, 2] - tri_p[:, 0]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    t_n = indices.shape[0]
    light_rows = np.zeros((t_n, _LIGHT_W), np.float32)
    light_rows[:, 0:9] = tri_p.reshape(t_n, 9)
    light_rows[:, 9] = rev.astype(np.float32)
    return TriangleSceneData(
        p=f32(cat["p"], device),
        n=f32(cat["n"], device),
        uv=f32(cat["uv"], device),
        indices=i32(indices[perm], device),
        orig_indices=i32(indices, device),
        orig_rev=torch.from_numpy(np.asarray(rev, bool)).to(device),
        tri_area=f32(area, device),
        rows8=f32(rows8, device),
        meta=i32(bvh8.meta, device),
        attr_rows=f32(_attr_for(cat, perm), device),
        light_rows=f32(light_rows, device),
        world_min=f32(lo.min(axis=0), device),
        world_max=f32(hi.max(axis=0), device),
        stack_depth=int(bvh8.max_depth),
        has_normals=bool(cat["has_normals"]),
        has_uv=bool(cat["has_uv"]),
        traverse=traverse,
    )


def _permute_to_max_z(v, kz):
    """Cyclic-permute (..., 3) vectors so component ``kz`` lands in z."""
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    is0 = kz == 0
    is1 = kz == 1
    ox = torch.where(is0, vy, torch.where(is1, vz, vx))
    oy = torch.where(is0, vz, torch.where(is1, vx, vy))
    oz = torch.where(is0, vx, torch.where(is1, vy, vz))
    return ox, oy, oz


def intersect_triangle(ray_o, ray_d, t_max, p0, p1, p2):
    """Watertight ray-triangle intersection (translate, permute, shear).

    All arguments broadcast over leading dims.  Returns
    (hit, t, b0, b1, b2).  The CUDA traversal kernel evaluates the same
    expressions in the same order (csrc/traverse_body.cuh)."""
    p0t = p0 - ray_o
    p1t = p1 - ray_o
    p2t = p2 - ray_o
    kz = torch.argmax(torch.abs(ray_d), dim=-1)
    dx, dy, dz = _permute_to_max_z(ray_d, kz)
    p0x, p0y, p0z = _permute_to_max_z(p0t, kz)
    p1x, p1y, p1z = _permute_to_max_z(p1t, kz)
    p2x, p2y, p2z = _permute_to_max_z(p2t, kz)
    dz_safe = torch.where(dz == 0.0, torch.ones_like(dz), dz)
    sx = -dx / dz_safe
    sy = -dy / dz_safe
    sz = 1.0 / dz_safe
    p0x = p0x + sx * p0z
    p0y = p0y + sy * p0z
    p1x = p1x + sx * p1z
    p1y = p1y + sy * p1z
    p2x = p2x + sx * p2z
    p2y = p2y + sy * p2z
    e0 = difference_of_products(p1x, p2y, p1y, p2x)
    e1 = difference_of_products(p2x, p0y, p2y, p0x)
    e2 = difference_of_products(p0x, p1y, p0y, p1x)
    same_sign = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0)) | (
        (e0 <= 0) & (e1 <= 0) & (e2 <= 0)
    )
    det = e0 + e1 + e2
    det_ok = det != 0.0
    p0z = p0z * sz
    p1z = p1z * sz
    p2z = p2z * sz
    t_scaled = e0 * p0z + e1 * p1z + e2 * p2z
    neg = det < 0.0
    t_ok = torch.where(
        neg,
        (t_scaled <= 1e-7 * det) & (t_scaled > t_max * det),
        (t_scaled >= 1e-7 * det) & (t_scaled < t_max * det),
    )
    hit = same_sign & det_ok & t_ok & (dz != 0.0)
    inv_det = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    t = t_scaled * inv_det
    b0 = e0 * inv_det
    b1 = e1 * inv_det
    b2 = e2 * inv_det
    return hit, torch.where(hit, t, torch.inf), b0, b1, b2


def intersect_triangle_mt(ray_o, ray_d, t_max, p0, e1, e2):
    """Moller-Trumbore test on pack-time edges ``e1 = p1 - p0``,
    ``e2 = p2 - p0`` (the reference kernel's SHIMMER_LEAF_MT leaf body,
    ``shimmer_tpu/ops/pallas/traverse.py:234-253``, in the same operand
    order, as the CUDA kernel evaluates it).  All arguments broadcast over
    leading dims.  Returns (hit, t) with t = inf where there is no hit."""
    ox, oy, oz = ray_o[..., 0], ray_o[..., 1], ray_o[..., 2]
    dx, dy, dz = ray_d[..., 0], ray_d[..., 1], ray_d[..., 2]
    e1x, e1y, e1z = e1[..., 0], e1[..., 1], e1[..., 2]
    e2x, e2y, e2z = e2[..., 0], e2[..., 1], e2[..., 2]
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    tvx, tvy, tvz = ox - p0[..., 0], oy - p0[..., 1], oz - p0[..., 2]
    u_s = tvx * pvx + tvy * pvy + tvz * pvz
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v_s = dx * qvx + dy * qvy + dz * qvz
    t_scaled = e2x * qvx + e2y * qvy + e2z * qvz
    w_s = det - u_s - v_s
    same_sign = ((u_s >= 0) & (v_s >= 0) & (w_s >= 0)) | (
        (u_s <= 0) & (v_s <= 0) & (w_s <= 0)
    )
    det_ok = det != 0.0
    neg = det < 0.0
    t_ok = torch.where(
        neg,
        (t_scaled <= 1e-7 * det) & (t_scaled > t_max * det),
        (t_scaled >= 1e-7 * det) & (t_scaled < t_max * det),
    )
    hit = same_sign & det_ok & t_ok
    inv_det = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    return hit, torch.where(hit, t_scaled * inv_det, torch.inf)


def _traverse_raw(tris: TriangleSceneData, ray_o, ray_d, t_max, any_hit):
    """Closest-hit / per-lane any-hit traversal returning ``(t, tri)`` with
    t = +inf on a miss.  Dispatches by the rays' device inside
    ``ops.traverse.traverse_raw``: CUDA tensors launch the hand-written
    kernel of the table's configuration, CPU tensors run the plain torch
    version."""
    from shimmer_tpu_torch.ops.traverse import traverse_raw

    return traverse_raw(tris, ray_o, ray_d, t_max, any_hit=any_hit)


def triangle_interaction_from_raw(tris: TriangleSceneData, ray_o, ray_d, tri) -> SurfaceInteraction:
    """Interaction from a raw traversal result: re-intersect the winning
    triangle (identical watertight formulas, so the hit decision
    reproduces the watertight traversal's given equal inputs) from ONE
    packed attribute-row gather per lane.

    A lane counts as a hit only where the re-intersection hits too.  A
    Moller-Trumbore leaf test can accept a triangle that the watertight
    test misses at an edge; such a lane becomes a clean miss (tri = -1,
    t = inf, ids -1) instead of reaching shading with t = inf.  The
    reference keeps ``tri >= 0`` there."""
    attr = tris.attr_rows[torch.clamp(tri, min=0).long()]
    p0 = attr[..., _A_P0 + 0 : _A_P0 + 3]
    p1 = attr[..., _A_P0 + 3 : _A_P0 + 6]
    p2 = attr[..., _A_P0 + 6 : _A_P0 + 9]
    t_inf = torch.full(ray_o.shape[:-1], torch.inf, device=ray_o.device)
    rehit, t, b0, b1, b2 = intersect_triangle(ray_o, ray_d, t_inf, p0, p1, p2)
    hit = (tri >= 0) & rehit
    tri = torch.where(hit, tri, -1)
    b0 = torch.where(hit, b0, 0.0)
    b1 = torch.where(hit, b1, 0.0)
    b2 = torch.where(hit, b2, 0.0)
    return build_triangle_interaction(
        tris.has_normals, ray_d, t, tri, b0, b1, b2, p0, p1, p2, attr
    )


def build_triangle_interaction(has_normals, ray_d, t, tri, b0, b1, b2, p0, p1, p2, attr):
    """Interaction construction from a winning triangle and its
    pre-gathered (N, 32) attribute rows."""
    valid = tri >= 0
    p_hit = b0[..., None] * p0 + b1[..., None] * p1 + b2[..., None] * p2
    dp02 = p0 - p2
    dp12 = p1 - p2
    ng = cross(dp02, dp12)
    degenerate = length_squared(ng) < 1e-24
    z_axis = torch.tensor([0.0, 0.0, 1.0], device=ng.device)
    n_geom = normalize(torch.where(degenerate[..., None], z_axis, ng))

    uv0 = attr[..., _A_UV + 0 : _A_UV + 2]
    uv1 = attr[..., _A_UV + 2 : _A_UV + 4]
    uv2 = attr[..., _A_UV + 4 : _A_UV + 6]
    uv_hit = b0[..., None] * uv0 + b1[..., None] * uv1 + b2[..., None] * uv2
    duv02 = uv0 - uv2
    duv12 = uv1 - uv2
    det_uv = difference_of_products(
        duv02[..., 0], duv12[..., 1], duv02[..., 1], duv12[..., 0]
    )
    uv_ok = torch.abs(det_uv) >= 1e-9
    inv_det = 1.0 / torch.where(uv_ok, det_uv, torch.ones_like(det_uv))
    dpdu = (duv12[..., 1:2] * dp02 - duv02[..., 1:2] * dp12) * inv_det[..., None]
    dpdv = (-duv12[..., 0:1] * dp02 + duv02[..., 0:1] * dp12) * inv_det[..., None]
    fx, fy = coordinate_system(n_geom)
    bad_uv = ~uv_ok | (length_squared(cross(dpdu, dpdv)) < 1e-24)
    dpdu = torch.where(bad_uv[..., None], fx, dpdu)
    dpdv = torch.where(bad_uv[..., None], fy, dpdv)

    rev = attr[..., _A_REV] > 0.5
    n_geom = torch.where(rev[..., None], -n_geom, n_geom)
    if has_normals:
        ns0 = attr[..., _A_NS + 0 : _A_NS + 3]
        ns1 = attr[..., _A_NS + 3 : _A_NS + 6]
        ns2 = attr[..., _A_NS + 6 : _A_NS + 9]
        ns = b0[..., None] * ns0 + b1[..., None] * ns1 + b2[..., None] * ns2
        has_ns = length_squared(ns) > 1e-12
        ns = torch.where(has_ns[..., None], normalize(ns), n_geom)
        ns = torch.where(rev[..., None], torch.where(has_ns[..., None], -ns, ns), ns)
        n_geom = torch.where(
            (has_ns & (dot(n_geom, ns) < 0.0))[..., None], -n_geom, n_geom
        )
    else:
        ns = n_geom
    material_id = attr[..., _A_MAT].to(torch.int32)
    area_light_id = attr[..., _A_ALI].to(torch.int32)
    return SurfaceInteraction(
        valid=valid,
        t=torch.where(valid, t, torch.inf),
        p=p_hit,
        n=n_geom,
        uv=uv_hit,
        wo=-normalize(ray_d),
        dpdu=dpdu,
        dpdv=dpdv,
        ns=ns,
        dpdus=dpdu,
        material_id=torch.where(valid, material_id, -1),
        area_light_id=torch.where(valid, area_light_id, -1),
        med_in=torch.where(valid, attr[..., _A_MI].to(torch.int32), -2),
        med_out=torch.where(valid, attr[..., _A_MO].to(torch.int32), -2),
    )


# --- area-light sampling over original triangle ids ---


def _orig_tri_verts(tris: TriangleSceneData, tri_idx):
    row = tris.light_rows[tri_idx.long()]
    return row[..., 0:3], row[..., 3:6], row[..., 6:9], row[..., 9] > 0.5


def triangle_light_sample(tris: TriangleSceneData, tri_idx, ref_p, ref_ns, u):
    """Solid-angle sampling of triangle ``tri_idx`` from ref_p: spherical
    triangle sampling between the area thresholds, area sampling outside.
    Returns (p, n, pdf_solid_angle)."""
    p0, p1, p2, rev = _orig_tri_verts(tris, tri_idx)
    solid_angle = spherical_triangle_area(
        normalize(p0 - ref_p), normalize(p1 - ref_p), normalize(p2 - ref_p)
    )
    use_area = (solid_angle < MIN_SPHERICAL_SAMPLE_AREA) | (
        solid_angle > MAX_SPHERICAL_SAMPLE_AREA
    )
    ng = cross(p1 - p0, p2 - p0)
    n_unnorm = torch.where(rev[..., None], -ng, ng)

    bary_a = sample_uniform_triangle(u)
    p_a = bary_a[..., 0:1] * p0 + bary_a[..., 1:2] * p1 + bary_a[..., 2:3] * p2
    area = 0.5 * length(ng)
    wi_a = p_a - ref_p
    dist2_a = torch.sum(wi_a * wi_a, -1)
    n_norm = normalize(n_unnorm)
    cos_a = torch.abs(dot(n_norm, -normalize(wi_a)))
    pdf_a = torch.where(
        (cos_a > 1e-9) & (dist2_a > 0.0),
        dist2_a / (torch.clamp(cos_a, min=1e-9) * torch.clamp(area, min=1e-12)),
        0.0,
    )

    bary_s, pdf_s = sample_spherical_triangle(p0, p1, p2, ref_p, u)
    p_s = bary_s[..., 0:1] * p0 + bary_s[..., 1:2] * p1 + bary_s[..., 2:3] * p2

    p_out = torch.where(use_area[..., None], p_a, p_s)
    pdf = torch.where(use_area, pdf_a, pdf_s)
    return p_out, n_norm, pdf


def triangle_light_pdf(tris: TriangleSceneData, tri_idx, ref_p, ref_ns, wi, si_p, si_n):
    """Solid-angle pdf of reaching si_p on triangle ``tri_idx`` (for MIS)."""
    p0, p1, p2, _ = _orig_tri_verts(tris, tri_idx)
    solid_angle = spherical_triangle_area(
        normalize(p0 - ref_p), normalize(p1 - ref_p), normalize(p2 - ref_p)
    )
    use_area = (solid_angle < MIN_SPHERICAL_SAMPLE_AREA) | (
        solid_angle > MAX_SPHERICAL_SAMPLE_AREA
    )
    ng = cross(p1 - p0, p2 - p0)
    area = 0.5 * length(ng)
    dist2 = distance_squared(ref_p, si_p)
    cos_s = torch.abs(dot(normalize(ng), -normalize(si_p - ref_p)))
    pdf_a = torch.where(
        cos_s > 1e-9,
        dist2 / (torch.clamp(cos_s, min=1e-9) * torch.clamp(area, min=1e-12)),
        0.0,
    )
    pdf_s = torch.where(
        solid_angle > 0.0, 1.0 / torch.clamp(solid_angle, min=1e-12), 0.0
    )
    return torch.where(use_area, pdf_a, pdf_s)
