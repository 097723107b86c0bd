"""Analytic spheres, batched SoA (port of ``shimmer_tpu/shapes/sphere.py``).

Spheres live in a flat table (``SphereData``); intersection tests every
ray against every sphere, an (N, S) broadcast, with the robust quadratic,
and keeps the closest hit.  Partial spheres (z_min / z_max / phi_max),
reverse orientation, uniform-area sampling and the cone sampling toward a
reference point (``sphere_sample_with_context`` / ``sphere_pdf_with_context``)
follow the reference line by line.  This is plain tensor code on every
device: the reference has no kernel for it either.

The 4x4 products are spelled out in the order the reference's contraction
adds them on the CPU, so that the results are bit-equal to the reference's
op-by-op evaluation (a plain left-to-right sum differs in the last bit on
a third of the coordinates).  Rays against the table (one matrix per
sphere, broadcast over the lanes) add pairwise, ``(m[i,0]*x + m[i,1]*y) +
(m[i,2]*z + m[i,3]*w)``; a matrix gathered per lane is a batched product,
which accumulates left to right with fused multiply-adds
(``_apply_m_lanes``, the fused step emulated in float64).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from benchmark.reference.frozen.config import f32, i32, resolve_device
from benchmark.reference.frozen.ops.math import (
    dot_lanes,
    quadratic,
    safe_acos,
    safe_sqrt,
    sqr,
    sqrt,
    take_wrapped,
)
from benchmark.reference.frozen.ops.sampling import sample_uniform_sphere
from benchmark.reference.frozen.ops.transform import Transform
from benchmark.reference.frozen.ops.vecmath import (
    Frame,
    distance_squared,
    dot,
    length,
    normalize,
    spherical_phi,
)
from benchmark.reference.frozen.shapes.interaction import SurfaceInteraction


@dataclasses.dataclass(frozen=True)
class SphereData:
    """Flat sphere table: (S,) parameter columns and (S, 4, 4) transforms."""

    radius: torch.Tensor
    z_min: torch.Tensor
    z_max: torch.Tensor
    theta_z_min: torch.Tensor
    theta_z_max: torch.Tensor
    phi_max: torch.Tensor               # radians
    object_to_render: torch.Tensor      # (S, 4, 4)
    render_to_object: torch.Tensor      # (S, 4, 4)
    reverse_orientation: torch.Tensor   # (S,) bool
    material_id: torch.Tensor           # (S,) int32
    area_light_id: torch.Tensor         # (S,) int32


def make_sphere_data(spheres: list[dict], device=None) -> SphereData:
    """Host: the table from dicts with keys radius, z_min, z_max, phi_max
    (degrees), object_to_render (a Transform), reverse_orientation,
    material_id and area_light_id, on ``device`` (default: the CUDA card)."""
    device = resolve_device(device)

    def g(k, d):
        return np.array([s.get(k, d) for s in spheres], np.float32)

    radius = g("radius", 1.0)
    z_min = np.maximum(
        np.array([s.get("z_min", -s.get("radius", 1.0)) for s in spheres], np.float32), -radius
    )
    z_max = np.minimum(
        np.array([s.get("z_max", s.get("radius", 1.0)) for s in spheres], np.float32), radius
    )
    o2r = np.stack([np.asarray(s.get("object_to_render", Transform.identity()).m)
                    for s in spheres])
    r2o = np.stack([np.asarray(s.get("object_to_render", Transform.identity()).m_inv)
                    for s in spheres])
    return SphereData(
        radius=f32(radius, device),
        z_min=f32(z_min, device),
        z_max=f32(z_max, device),
        theta_z_min=f32(np.arccos(np.clip(z_min / radius, -1, 1)), device),
        theta_z_max=f32(np.arccos(np.clip(z_max / radius, -1, 1)), device),
        phi_max=f32(np.deg2rad(g("phi_max", 360.0)), device),
        object_to_render=f32(o2r, device),
        render_to_object=f32(r2o, device),
        reverse_orientation=torch.from_numpy(
            np.array([bool(s.get("reverse_orientation", False)) for s in spheres])
        ).to(device),
        material_id=i32(g("material_id", -1).astype(np.int32), device),
        area_light_id=i32(g("area_light_id", -1).astype(np.int32), device),
    )


def _apply_m(m, p, w: float):
    """First three rows of the (1, S, 4, 4) table times [p, w] for
    (N, S, 3) points: the pairwise sum."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return torch.stack(
        [(m[..., i, 0] * x + m[..., i, 1] * y) + (m[..., i, 2] * z + m[..., i, 3] * w)
         for i in range(3)],
        dim=-1,
    )


def _apply_m_lanes(m, p, w: float):
    """First three rows of per-lane (..., 4, 4) matrices times [p, w]."""
    wt = torch.full_like(p[..., 0], w)
    return torch.stack(
        [dot_lanes([(m[..., i, 0], p[..., 0]), (m[..., i, 1], p[..., 1]),
                     (m[..., i, 2], p[..., 2]), (m[..., i, 3], wt)]) for i in range(3)],
        dim=-1,
    )


def _apply_normal(r2o, n):
    """Normal transform by per-lane matrices: the inverse transpose of
    object_to_render, i.e. the transpose of render_to_object's 3x3."""
    return torch.stack(
        [dot_lanes([(r2o[..., j, i], n[..., j]) for j in range(3)]) for i in range(3)],
        dim=-1,
    )


def sphere_intersect(data: SphereData, ray_o, ray_d, t_max) -> SurfaceInteraction:
    """Closest hit of each ray against every sphere: ray_o, ray_d (N, 3),
    t_max (N,) -> SurfaceInteraction (N,)."""
    m_inv = data.render_to_object[None]             # (1, S, 4, 4)
    o = _apply_m(m_inv, ray_o[:, None, :], 1.0)    # (N, S, 3)
    d = _apply_m(m_inv, ray_d[:, None, :], 0.0)

    a = torch.sum(d * d, dim=-1)
    b = 2.0 * torch.sum(o * d, dim=-1)
    c = torch.sum(o * o, dim=-1) - sqr(data.radius)[None]
    has, t0, t1 = quadratic(a, b, c)
    full_z = (data.z_min <= -data.radius + 1e-7) & (data.z_max >= data.radius - 1e-7)

    def hit_ok(t):
        p = o + t[..., None] * d
        # Reproject onto the surface.
        p = p * (data.radius[None] / torch.clamp(length(p), min=1e-20))[..., None]
        phi = spherical_phi(p)
        z_ok = (p[..., 2] >= data.z_min[None] - 1e-6) & (p[..., 2] <= data.z_max[None] + 1e-6)
        z_ok = z_ok | full_z[None]
        phi_ok = phi <= data.phi_max[None] + 1e-6
        return (t > 1e-6) & (t < t_max[:, None]) & z_ok & phi_ok, p, phi

    ok0, p0, phi0 = hit_ok(t0)
    ok1, p1, phi1 = hit_ok(t1)
    use1 = ~ok0 & ok1
    t_hit = torch.where(ok0, t0, torch.where(use1, t1, torch.inf))
    p_obj = torch.where(use1[..., None], p1, p0)
    phi = torch.where(use1, phi1, phi0)
    hit = has & (ok0 | ok1)
    t_hit = torch.where(hit, t_hit, torch.inf)

    # Closest sphere per ray (the first of equal t, as the reference).
    best = torch.argmin(t_hit, dim=-1)             # (N,)
    t_best = torch.gather(t_hit, 1, best[:, None])[:, 0]
    valid = torch.isfinite(t_best)
    p_obj = torch.gather(p_obj, 1, best[:, None, None].expand(-1, 1, 3))[:, 0]
    phi = torch.gather(phi, 1, best[:, None])[:, 0]

    radius = data.radius[best]
    phi_max = data.phi_max[best]
    theta_z_min = data.theta_z_min[best]
    theta_z_max = data.theta_z_max[best]
    o2r = data.object_to_render[best]
    r2o = data.render_to_object[best]

    # uv and partials in object space.
    theta = safe_acos(p_obj[..., 2] / radius)
    u = phi / phi_max
    v = (theta - theta_z_min) / torch.where(
        theta_z_max != theta_z_min, theta_z_max - theta_z_min, torch.ones_like(theta_z_max)
    )
    z_radius = sqrt(torch.clamp(sqr(p_obj[..., 0]) + sqr(p_obj[..., 1]), min=1e-20))
    cos_phi = p_obj[..., 0] / z_radius
    sin_phi = p_obj[..., 1] / z_radius
    dpdu = torch.stack(
        [-phi_max * p_obj[..., 1], phi_max * p_obj[..., 0], torch.zeros_like(phi)], dim=-1
    )
    sin_theta = safe_sqrt(1.0 - sqr(p_obj[..., 2] / radius))
    dpdv = (theta_z_max - theta_z_min)[..., None] * torch.stack(
        [p_obj[..., 2] * cos_phi, p_obj[..., 2] * sin_phi, -radius * sin_theta], dim=-1
    )

    # To render space.
    p = _apply_m_lanes(o2r, p_obj, 1.0)
    n = normalize(_apply_normal(r2o, normalize(p_obj)))
    rev = data.reverse_orientation[best]
    n = torch.where(rev[..., None], -n, n)
    return SurfaceInteraction.make(
        valid=valid,
        t=torch.where(valid, t_best, torch.inf),
        p=p,
        n=n,
        uv=torch.stack([u, v], dim=-1),
        wo=-normalize(ray_d),
        dpdu=_apply_m_lanes(o2r, dpdu, 0.0),
        dpdv=_apply_m_lanes(o2r, dpdv, 0.0),
        material_id=torch.where(valid, data.material_id[best], -1),
        area_light_id=torch.where(valid, data.area_light_id[best], -1),
    )


def sphere_intersect_predicate(data: SphereData, ray_o, ray_d, t_max):
    """Any-hit shadow test."""
    return sphere_intersect(data, ray_o, ray_d, t_max).valid


def sphere_area(data: SphereData):
    """(S,) areas: phi_max * r * (z_max - z_min)."""
    return data.phi_max * data.radius * (data.z_max - data.z_min)


def sphere_sample(data: SphereData, idx, u):
    """Uniform area sample of sphere ``idx`` per lane: (p, n, pdf_area)."""
    radius = take_wrapped(data.radius, idx)
    o2r = take_wrapped(data.object_to_render, idx)
    r2o = take_wrapped(data.render_to_object, idx)
    p_obj = radius[..., None] * sample_uniform_sphere(u)
    p = _apply_m_lanes(o2r, p_obj, 1.0)
    n = normalize(_apply_normal(r2o, p_obj))
    n = torch.where(take_wrapped(data.reverse_orientation, idx)[..., None], -n, n)
    pdf = 1.0 / take_wrapped(sphere_area(data), idx)
    return p, n, pdf


def sphere_sample_with_context(data: SphereData, idx, ref_p, ref_ns, u):
    """Solid-angle sample toward sphere ``idx`` from ref_p: the subtended
    cone from outside, uniform area (converted to solid angle) from
    inside.  Returns (p, n, pdf_solid_angle)."""
    radius = take_wrapped(data.radius, idx)
    o2r = take_wrapped(data.object_to_render, idx)
    center = _apply_m_lanes(o2r, torch.zeros_like(ref_p), 1.0)
    dc2 = distance_squared(ref_p, center)
    outside = dc2 > sqr(radius) * (1.0 + 1e-4)

    # Outside: sample the cone; the frame's z points from the center
    # toward the reference point.
    dc = sqrt(torch.clamp(dc2, min=1e-20))
    inv_dc = 1.0 / dc
    frame = Frame.from_z((ref_p - center) * inv_dc[..., None])
    sin2_theta_max = sqr(radius) / dc2
    cos_theta_max = safe_sqrt(1.0 - sin2_theta_max)
    cos_theta = (cos_theta_max - 1.0) * u[..., 0] + 1.0
    sin2_theta = 1.0 - sqr(cos_theta)
    small = sin2_theta_max < 0.00068523
    sin2_theta = torch.where(small, sin2_theta_max * u[..., 0], sin2_theta)
    cos_theta = torch.where(small, safe_sqrt(1.0 - sin2_theta), cos_theta)
    cos_alpha = sin2_theta * dc / radius + cos_theta * safe_sqrt(
        1.0 - sin2_theta * sqr(dc) / sqr(radius)
    )
    sin_alpha = safe_sqrt(1.0 - sqr(cos_alpha))
    phi = u[..., 1] * 2.0 * math.pi
    w_dir = torch.stack(
        [sin_alpha * torch.cos(phi), sin_alpha * torch.sin(phi), cos_alpha], dim=-1
    )
    n_out = frame.from_local(w_dir)
    p_out = center + radius[..., None] * n_out
    pdf_out = 1.0 / (2.0 * math.pi * torch.clamp(1.0 - cos_theta_max, min=1e-9))

    # Inside: uniform area, converted to solid angle.
    p_in, n_in, pdf_area = sphere_sample(data, idx, u)
    wi = p_in - ref_p
    dist2 = torch.sum(wi * wi, dim=-1)
    cos_surf = torch.abs(dot(n_in, -normalize(wi)))
    pdf_in = pdf_area * dist2 / torch.clamp(cos_surf, min=1e-9)
    pdf_in = torch.where(cos_surf <= 1e-9, 0.0, pdf_in)

    rev = take_wrapped(data.reverse_orientation, idx)
    n_out = torch.where(rev[..., None], -n_out, n_out)
    p = torch.where(outside[..., None], p_out, p_in)
    n = torch.where(outside[..., None], n_out, n_in)
    pdf = torch.where(outside, pdf_out, pdf_in)
    return p, n, pdf


def sphere_pdf_with_context(data: SphereData, idx, ref_p, wi, si_p, si_n):
    """Solid-angle pdf of sampling direction wi toward sphere ``idx``."""
    radius = take_wrapped(data.radius, idx)
    o2r = take_wrapped(data.object_to_render, idx)
    center = _apply_m_lanes(o2r, torch.zeros_like(ref_p), 1.0)
    dc2 = distance_squared(ref_p, center)
    outside = dc2 > sqr(radius) * (1.0 + 1e-4)

    sin2_theta_max = sqr(radius) / dc2
    cos_theta_max = safe_sqrt(1.0 - sin2_theta_max)
    pdf_out = 1.0 / (2.0 * math.pi * torch.clamp(1.0 - cos_theta_max, min=1e-9))

    # Inside: the area pdf at the given hit point, in solid angle.
    dist2 = distance_squared(ref_p, si_p)
    cos_surf = torch.abs(dot(si_n, -normalize(si_p - ref_p)))
    pdf_area = 1.0 / take_wrapped(sphere_area(data), idx)
    pdf_in = torch.where(
        cos_surf > 1e-9, pdf_area * dist2 / torch.clamp(cos_surf, min=1e-9), 0.0
    )
    return torch.where(outside, pdf_out, pdf_in)
