"""Bilinear patches, pbrt-v4's ``bilinearmesh`` (port of
``shimmer_tpu/shapes/bilinear.py``).

The patch is p(u,v) = (1-u)(1-v) p00 + u(1-v) p10 + (1-u)v p01 + uv p11.
Every ray is tested against every patch, an (N, B) broadcast: the ray
meets the surface where a quadratic in u vanishes (both roots evaluated
branch-free, the linear root when the twist term is 0), then v and t come
from Cramer's rule.  Area lights sample a patch in proportion to its
corner normals' magnitudes (``sample_bilinear``) and convert to a
solid-angle pdf.  Plain tensor code on every device: the reference has no
kernel for it either, and scenes keep few patches (quad lights, floors,
walls); meshes of many quads belong in the triangle path.

The corners reach render space as the reference puts them there: the
render-from-object matrix is composed in float32 as the reference's XLA
dot adds on the CPU (left to right with fused multiply-adds), then applied
to each corner in float64 and rounded once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference.frozen.config import f32, i32, resolve_device
from benchmark.reference.frozen.ops.math import difference_of_products, quadratic, take_wrapped
from benchmark.reference.frozen.ops.sampling import bilinear_pdf, sample_bilinear
from benchmark.reference.frozen.ops.transform import Transform
from benchmark.reference.frozen.ops.vecmath import cross, distance_squared, dot, length, normalize
from benchmark.reference.frozen.shapes.interaction import SurfaceInteraction

_EPS_T = 1e-4
_DEFAULT_UV = ((0.0, 0.0), (1.0, 0.0), (0.0, 1.0), (1.0, 1.0))


@dataclasses.dataclass(frozen=True)
class BilinearPatchData:
    p00: torch.Tensor            # (B, 3) render-space corners
    p10: torch.Tensor
    p01: torch.Tensor
    p11: torch.Tensor
    uv: torch.Tensor             # (B, 4, 2) corner uvs [00, 10, 01, 11]
    material_id: torch.Tensor    # (B,) int32
    area_light_id: torch.Tensor  # (B,) int32, -1 = none
    reverse: torch.Tensor        # (B,) bool
    area: torch.Tensor           # (B,) surface area (4x4 Gauss-Legendre)
    has_uv: bool = False


def _bilerp(u, v, p00, p10, p01, p11):
    return (1 - u) * (1 - v) * p00 + u * (1 - v) * p10 + (1 - u) * v * p01 + u * v * p11


def compose_f32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b of float32 4x4 matrices as XLA's CPU dot computes it: each
    element left to right, the first product rounded, then one fused
    multiply-add per term (emulated in float64: a float32 product is exact
    there)."""
    a = np.asarray(a, np.float32).astype(np.float64)
    b = np.asarray(b, np.float32).astype(np.float64)
    acc = (a[:, 0:1] * b[0:1, :]).astype(np.float32)
    for k in range(1, 4):
        acc = (a[:, k:k + 1] * b[k:k + 1, :] + acc.astype(np.float64)).astype(np.float32)
    return acc


def make_bilinear_data(patches: list[dict], render_from_object: Transform | None = None,
                       device=None) -> BilinearPatchData:
    """Patch dicts with ``p00 p10 p01 p11`` (object or world space, (3,)),
    optional ``uv`` (4, 2), ``material_id``, ``area_light_id``,
    ``reverse`` and ``object_to_world`` (a Transform), moved to ``device``
    (default: the CUDA card)."""
    device = resolve_device(device)
    c = {k: [] for k in ("p00", "p10", "p01", "p11")}
    uvs, mids, alids, revs = [], [], [], []
    any_uv = False
    for s in patches:
        o2w = s.get("object_to_world")
        m = None
        if o2w is not None or render_from_object is not None:
            t = render_from_object or Transform.identity()
            m = np.asarray(t.m, np.float32)
            if o2w is not None:
                m = compose_f32(m, o2w.m)
        for k in c:
            p = np.asarray(s[k], np.float64)
            if m is not None:
                ph = m @ np.append(p, 1.0)
                p = ph[:3] / ph[3]
            c[k].append(p.astype(np.float32))
        uv = s.get("uv")
        if uv is not None:
            any_uv = True
            uvs.append(np.asarray(uv, np.float32))
        else:
            uvs.append(np.asarray(_DEFAULT_UV, np.float32))
        mids.append(int(s.get("material_id", -1)))
        alids.append(int(s.get("area_light_id", -1)))
        revs.append(bool(s.get("reverse", False)))
    p00 = np.stack(c["p00"])
    p10 = np.stack(c["p10"])
    p01 = np.stack(c["p01"])
    p11 = np.stack(c["p11"])
    # 4x4 tensor Gauss-Legendre area over the float32 corners.
    gx, gw = np.polynomial.legendre.leggauss(4)
    gu = 0.5 * (gx + 1.0)
    gw = 0.5 * gw
    area = np.zeros(len(patches), np.float64)
    for iu in range(4):
        for iv in range(4):
            u, v = gu[iu], gu[iv]
            dpdu = (1 - v) * (p10 - p00) + v * (p11 - p01)
            dpdv = (1 - u) * (p01 - p00) + u * (p11 - p10)
            j = np.linalg.norm(np.cross(dpdu, dpdv), axis=-1)
            area += gw[iu] * gw[iv] * j
    return BilinearPatchData(
        p00=f32(p00, device),
        p10=f32(p10, device),
        p01=f32(p01, device),
        p11=f32(p11, device),
        uv=f32(np.stack(uvs), device),
        material_id=i32(mids, device),
        area_light_id=i32(alids, device),
        reverse=torch.from_numpy(np.asarray(revs, bool)).to(device),
        area=f32(area, device),
        has_uv=any_uv,
    )


def _intersect_uv(data: BilinearPatchData, ray_o, ray_d, t_max):
    """Every ray (N, 3) against every patch: (hit (N, B), t, u, v) with
    t = inf where there is no hit.  The point of parameter u lies on the
    segment pa(u) = lerp(u, p00, p10) .. pb(u) = lerp(u, p01, p11); the
    ray meets the surface where cross(pb - pa, d) . (pa - o) = 0, a
    quadratic in u."""
    o = ray_o[:, None, :]
    d = ray_d[:, None, :]
    p00, p10, p01, p11 = data.p00[None], data.p10[None], data.p01[None], data.p11[None]
    e0 = p01 - p00
    e1 = p11 - p01 - p10 + p00   # the twist
    f0 = p00 - o
    f1 = p10 - p00
    c0d = cross(e0, d)
    c1d = cross(e1, d)
    a = dot(c1d, f1)
    b = dot(c0d, f1) + dot(c1d, f0)
    c = dot(c0d, f0)
    has_root, u_lo, u_hi = quadratic(a, b, c)
    # A parallelogram has no twist: a == 0 and the single linear root.
    lin = (a == 0.0) & (b != 0.0)
    u_lin = -c / torch.where(b != 0.0, b, torch.ones_like(b))
    has_root = has_root | lin
    u_lo = torch.where(lin, u_lin, u_lo)
    u_hi = torch.where(lin, u_lin, u_hi)

    def eval_root(u):
        u_ = u[..., None]
        pa = p00 + u_ * (p10 - p00)
        pb = p01 + u_ * (p11 - p01)
        ud = pb - pa
        deltao = pa - o
        perp = cross(d, ud)
        p2 = dot(perp, perp)
        ok = p2 > 0.0
        inv = 1.0 / torch.where(ok, p2, torch.ones_like(p2))
        # t d - v ud = deltao, crossed with ud and with d.
        v = dot(cross(deltao, d), perp) * inv
        t = dot(cross(deltao, ud), perp) * inv
        good = (ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0) & (t > _EPS_T)
                & (t < t_max[:, None]))
        return good, t, v

    g_lo, t_lo, v_lo = eval_root(u_lo)
    g_hi, t_hi, v_hi = eval_root(u_hi)
    take_hi = g_hi & (~g_lo | (t_hi < t_lo))
    hit = has_root & (g_lo | g_hi)
    t = torch.where(take_hi, t_hi, t_lo)
    u = torch.where(take_hi, u_hi, u_lo)
    v = torch.where(take_hi, v_hi, v_lo)
    return hit, torch.where(hit, t, torch.inf), u, v


def _lane_t_max(t_max, ray_o):
    return torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=ray_o.device),
                              ray_o.shape[:-1])


def bilinear_intersect(data: BilinearPatchData, ray_o, ray_d, t_max) -> SurfaceInteraction:
    """Closest hit over all patches (the union's patch leg)."""
    hit, t, u, v = _intersect_uv(data, ray_o, ray_d, _lane_t_max(t_max, ray_o))
    idx = torch.argmin(t, dim=1)
    col = idx[:, None]
    valid = torch.gather(hit, 1, col)[:, 0]
    t_b = torch.gather(t, 1, col)[:, 0]
    u_ = torch.gather(u, 1, col)
    v_ = torch.gather(v, 1, col)
    p00, p10, p01, p11 = data.p00[idx], data.p10[idx], data.p01[idx], data.p11[idx]
    p = _bilerp(u_, v_, p00, p10, p01, p11)
    dpdu = (1 - v_) * (p10 - p00) + v_ * (p11 - p01)
    dpdv = (1 - u_) * (p01 - p00) + u_ * (p11 - p10)
    ng = normalize(cross(dpdu, dpdv))
    ng = torch.where(data.reverse[idx][:, None], -ng, ng)

    uvc = data.uv[idx]
    uv_out = _bilerp(u_, v_, uvc[:, 0], uvc[:, 1], uvc[:, 2], uvc[:, 3])
    if data.has_uv:
        # Chain rule through the uv bilerp: the render-space derivatives
        # with respect to the texture uv.
        duvdu = (1 - v_) * (uvc[:, 1] - uvc[:, 0]) + v_ * (uvc[:, 3] - uvc[:, 2])
        duvdv = (1 - u_) * (uvc[:, 2] - uvc[:, 0]) + u_ * (uvc[:, 3] - uvc[:, 1])
        det = difference_of_products(duvdu[:, 0], duvdv[:, 1], duvdu[:, 1], duvdv[:, 0])
        ok = torch.abs(det) > 1e-12
        inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
        dpdu_t = torch.where(ok[:, None],
                             (duvdv[:, 1:2] * dpdu - duvdu[:, 1:2] * dpdv) * inv[:, None], dpdu)
        dpdv_t = torch.where(ok[:, None],
                             (duvdu[:, 0:1] * dpdv - duvdv[:, 0:1] * dpdu) * inv[:, None], dpdv)
        dpdu, dpdv = dpdu_t, dpdv_t

    return SurfaceInteraction.make(
        valid=valid,
        t=torch.where(valid, t_b, torch.inf),
        p=p,
        n=ng,
        uv=uv_out,
        wo=-ray_d,
        dpdu=dpdu,
        dpdv=dpdv,
        ns=ng,
        dpdus=dpdu,
        material_id=torch.where(valid, data.material_id[idx], -1),
        area_light_id=torch.where(valid, data.area_light_id[idx], -1),
    )


def bilinear_occluded(data: BilinearPatchData, ray_o, ray_d, t_max):
    hit, _, _, _ = _intersect_uv(data, ray_o, ray_d, _lane_t_max(t_max, ray_o))
    return torch.any(hit, dim=1)


def _corners(data: BilinearPatchData, idx):
    """The corners of patch ``idx`` per lane, gathered as the reference
    gathers them (a negative id counts from the end, then ids are clamped):
    a lane whose light is on another shape reads a patch it discards."""
    return tuple(take_wrapped(x, idx) for x in (data.p00, data.p10, data.p01, data.p11))


def _corner_weights(p00, p10, p01, p11):
    return torch.stack([
        length(cross(p10 - p00, p01 - p00)),
        length(cross(p10 - p00, p11 - p10)),
        length(cross(p01 - p00, p11 - p01)),
        length(cross(p11 - p10, p11 - p01)),
    ], dim=-1)


def bilinear_light_sample(data: BilinearPatchData, idx, ref_p, ref_ns, u):
    """A point on patch ``idx`` in proportion to the local area
    distortion, as a solid-angle pdf from ``ref_p``.  Returns (p, n, pdf)."""
    p00, p10, p01, p11 = _corners(data, idx)
    w = _corner_weights(p00, p10, p01, p11)
    uv = sample_bilinear(u, w)
    pdf_uv = bilinear_pdf(uv, w)
    u_ = uv[..., 0:1]
    v_ = uv[..., 1:2]
    p = _bilerp(u_, v_, p00, p10, p01, p11)
    dpdu = (1 - v_) * (p10 - p00) + v_ * (p11 - p01)
    dpdv = (1 - u_) * (p01 - p00) + u_ * (p11 - p10)
    cr = cross(dpdu, dpdv)
    jac = length(cr)
    n = normalize(cr)
    n = torch.where(take_wrapped(data.reverse, idx)[..., None], -n, n)
    pdf_area = pdf_uv / torch.clamp(jac, min=1e-12)
    wi = p - ref_p
    dist2 = torch.sum(wi * wi, dim=-1)
    cos = torch.abs(dot(n, -normalize(wi)))
    pdf = torch.where((cos > 1e-9) & (dist2 > 0.0),
                      pdf_area * dist2 / torch.clamp(cos, min=1e-9), 0.0)
    return p, n, pdf


def bilinear_light_pdf(data: BilinearPatchData, idx, ref_p, ref_ns, wi, si_p, si_n):
    """The solid-angle pdf for MIS: re-intersect (ref_p, wi) with patch
    ``idx`` to recover (u, v), then the same area-to-solid-angle
    conversion."""
    hit, _, u, v = _intersect_uv(data, ref_p, wi,
                                 torch.full(ref_p.shape[:1], torch.inf, device=ref_p.device))
    n_patches = hit.shape[1]
    col = idx.long()
    col = torch.clamp(torch.where(col < 0, col + n_patches, col), 0, n_patches - 1)[:, None]
    hit_i = torch.gather(hit, 1, col)[:, 0]
    u_b = torch.gather(u, 1, col)
    v_b = torch.gather(v, 1, col)
    p00, p10, p01, p11 = _corners(data, idx)
    w = _corner_weights(p00, p10, p01, p11)
    pdf_uv = bilinear_pdf(torch.cat([u_b, v_b], dim=-1), w)
    dpdu = (1 - v_b) * (p10 - p00) + v_b * (p11 - p01)
    dpdv = (1 - u_b) * (p01 - p00) + u_b * (p11 - p10)
    jac = length(cross(dpdu, dpdv))
    pdf_area = pdf_uv / torch.clamp(jac, min=1e-12)
    dist2 = distance_squared(ref_p, si_p)
    cos = torch.abs(dot(normalize(si_n), -normalize(si_p - ref_p)))
    return torch.where(hit_i & (cos > 1e-9), pdf_area * dist2 / torch.clamp(cos, min=1e-9), 0.0)
