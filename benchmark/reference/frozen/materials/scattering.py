"""Microfacet distribution and Fresnel utilities, batched over lanes (port
of ``shimmer_tpu/materials/scattering.py``): Trowbridge-Reitz (GGX) with
visible-normal sampling, dielectric and complex Fresnel, refraction and
the Henyey-Greenstein phase function.

Alpha parameters are per-lane tensors; the effectively-smooth case is a
mask that callers combine with the rough path.  Both sides of every
``torch.where`` are computed, as ``jnp.where`` computes them, so an
untaken side may hold inf or NaN; the guards the reference puts in front
of such values are kept, and the taken values are the same.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.frozen.ops.math import lerp, safe_sqrt, sqr, sqrt
from benchmark.reference.frozen.ops.sampling import sample_uniform_disk_polar
from benchmark.reference.frozen.ops.vecmath import (
    Frame,
    abs_cos_theta,
    abs_dot,
    cos2_theta,
    cos_phi,
    cross,
    dot,
    normalize,
    sin_phi,
    tan2_theta,
    vec,
)

EFFECTIVELY_SMOOTH = 1e-3


def _const(values, like):
    return torch.tensor(values, dtype=torch.float32, device=like.device).expand(like.shape)


def clamp_alpha(alpha_x, alpha_y):
    """alpha >= 1e-4 for every lane (effectively-smooth lanes stay
    classified as smooth; their rough-branch math no longer overflows)."""
    return torch.clamp(alpha_x, min=1e-4), torch.clamp(alpha_y, min=1e-4)


def effectively_smooth(alpha_x, alpha_y):
    return (alpha_x < EFFECTIVELY_SMOOTH) & (alpha_y < EFFECTIVELY_SMOOTH)


def tr_d(wm, alpha_x, alpha_y):
    """GGX normal distribution D(wm)."""
    t2 = tan2_theta(wm)
    cos4 = sqr(cos2_theta(wm))
    ok = torch.isfinite(t2) & (cos4 >= 1e-16)
    t2 = torch.where(ok, t2, 0.0)
    e = t2 * (sqr(cos_phi(wm) / alpha_x) + sqr(sin_phi(wm) / alpha_y))
    ok = ok & (e < 1e16)
    e = torch.where(ok, e, 0.0)
    d = 1.0 / (math.pi * alpha_x * alpha_y * torch.clamp(cos4, min=1e-16) * sqr(1.0 + e))
    return torch.where(ok, d, 0.0)


def tr_lambda(w, alpha_x, alpha_y):
    t2 = tan2_theta(w)
    finite = torch.isfinite(t2)
    t2 = torch.where(finite, t2, 0.0)
    alpha2 = sqr(cos_phi(w) * alpha_x) + sqr(sin_phi(w) * alpha_y)
    lam = (-1.0 + safe_sqrt(1.0 + alpha2 * t2)) / 2.0
    return torch.where(finite, lam, 0.0)


def tr_g1(w, alpha_x, alpha_y):
    return 1.0 / (1.0 + tr_lambda(w, alpha_x, alpha_y))


def tr_g(wo, wi, alpha_x, alpha_y):
    return 1.0 / (1.0 + tr_lambda(wo, alpha_x, alpha_y) + tr_lambda(wi, alpha_x, alpha_y))


def tr_pdf(w, wm, alpha_x, alpha_y):
    """Visible-normal pdf D_w(wm)."""
    return (
        tr_g1(w, alpha_x, alpha_y)
        / torch.clamp(abs_cos_theta(w), min=1e-9)
        * tr_d(wm, alpha_x, alpha_y)
        * abs_dot(w, wm)
    )


def tr_sample_wm(w, u, alpha_x, alpha_y):
    """Visible-normal sampling (Heitz 2018)."""
    wh = normalize(torch.stack([alpha_x * w[..., 0], alpha_y * w[..., 1], w[..., 2]], dim=-1))
    wh = torch.where((wh[..., 2] < 0.0)[..., None], -wh, wh)
    t1_raw = cross(_const([0.0, 0.0, 1.0], wh), wh)
    straight = (wh[..., 2] >= 0.99999)[..., None]
    x_axis = _const([1.0, 0.0, 0.0], wh)
    t1 = torch.where(straight, x_axis, normalize(torch.where(straight, x_axis, t1_raw)))
    t2 = cross(wh, t1)
    p = sample_uniform_disk_polar(u)
    h = safe_sqrt(1.0 - sqr(p[..., 0]))
    py = lerp((1.0 + wh[..., 2]) / 2.0, h, p[..., 1])
    pz = safe_sqrt(1.0 - sqr(p[..., 0]) - sqr(py))
    nh = p[..., 0:1] * t1 + py[..., None] * t2 + pz[..., None] * wh
    return normalize(
        torch.stack(
            [alpha_x * nh[..., 0], alpha_y * nh[..., 1], torch.clamp(nh[..., 2], min=1e-6)],
            dim=-1,
        )
    )


def roughness_to_alpha(roughness):
    """alpha = sqrt(roughness)."""
    return sqrt(roughness.to(torch.float32))


def regularize_alpha(alpha):
    """Roughen near-specular lobes after non-specular bounces."""
    return torch.where(alpha < 0.3, torch.clamp(2.0 * alpha, 0.1, 0.3), alpha)


# --- Fresnel / refraction ---


def reflect(wo, n):
    return -wo + 2.0 * dot(wo, n)[..., None] * n


def refract(wi, n, eta):
    """Snell refraction with wi on either side (n and eta flip when wi is
    below n).  Returns (refracted wt, eta_used, valid)."""
    ci = dot(n, wi)
    flip = ci < 0.0
    eta_eff = torch.where(flip, 1.0 / eta, eta)
    n_eff = torch.where(flip[..., None], -n, n)
    ci = torch.abs(ci)
    s2i = torch.clamp(1.0 - sqr(ci), min=0.0)
    s2t = s2i / sqr(eta_eff)
    tir = s2t >= 1.0
    ct = safe_sqrt(torch.clamp(1.0 - s2t, min=0.0))
    wt = -wi / eta_eff[..., None] + (ci / eta_eff - ct)[..., None] * n_eff
    return wt, eta_eff, ~tir


def fresnel_dielectric(cos_theta_i, eta):
    """Unpolarized dielectric Fresnel reflectance."""
    ci = torch.clamp(cos_theta_i, -1.0, 1.0)
    flip = ci < 0.0
    eta_eff = torch.where(flip, 1.0 / eta, eta)
    ci = torch.abs(ci)
    s2i = 1.0 - sqr(ci)
    s2t = s2i / sqr(eta_eff)
    tir = s2t >= 1.0
    ct = safe_sqrt(torch.clamp(1.0 - s2t, min=0.0))
    denom1 = eta_eff * ci + ct
    denom2 = ci + eta_eff * ct
    r_parl = (eta_eff * ci - ct) / torch.where(denom1 == 0, 1.0, denom1)
    r_perp = (ci - eta_eff * ct) / torch.where(denom2 == 0, 1.0, denom2)
    f = (sqr(r_parl) + sqr(r_perp)) / 2.0
    return torch.where(tir, 1.0, f)


def fresnel_complex(cos_theta_i, eta, k):
    """Conductor Fresnel with complex IOR eta - i k, in explicit (re, im)
    arithmetic."""
    ci = torch.clamp(cos_theta_i, 0.0, 1.0)
    s2 = 1.0 - sqr(ci)
    e2r = sqr(eta) - sqr(k)
    e2i = -2.0 * eta * k
    denom = sqr(e2r) + sqr(e2i)
    denom = torch.where(denom == 0, 1.0, denom)
    s2tr = s2 * e2r / denom
    s2ti = -s2 * e2i / denom
    c2r = 1.0 - s2tr
    c2i = -s2ti
    r = sqrt(torch.clamp(sqr(c2r) + sqr(c2i), min=1e-30))
    ctr = safe_sqrt((r + c2r) / 2.0)
    cti = torch.sign(c2i + 1e-30) * safe_sqrt((r - c2r) / 2.0)
    ar = eta * ci
    ai = -k * ci
    num_r, num_i = ar - ctr, ai - cti
    den_r, den_i = ar + ctr, ai + cti
    dd = sqr(den_r) + sqr(den_i)
    dd = torch.where(dd == 0, 1.0, dd)
    rp2 = (sqr(num_r) + sqr(num_i)) / dd
    br = eta * ctr - k * cti
    bi = eta * cti + k * ctr
    num_r, num_i = ci - br, -bi
    den_r, den_i = ci + br, bi
    dd = sqr(den_r) + sqr(den_i)
    dd = torch.where(dd == 0, 1.0, dd)
    rs2 = (sqr(num_r) + sqr(num_i)) / dd
    return (rp2 + rs2) / 2.0


def henyey_greenstein(cos_theta, g):
    """HG phase function."""
    g = torch.clamp(g, -0.99, 0.99)
    denom = 1.0 + sqr(g) + 2.0 * g * cos_theta
    return (1.0 - sqr(g)) / (denom * safe_sqrt(torch.clamp(denom, min=1e-9)) * 4.0 * math.pi)


def sample_henyey_greenstein(wo, g, u):
    """Sample the HG phase function.  Returns (wi, pdf)."""
    g = torch.clamp(g, -0.99, 0.99)
    gz = torch.abs(g) > 1e-3
    sq = (1.0 - sqr(g)) / (1.0 + g - 2.0 * g * u[..., 0])
    ct_g = -(1.0 + sqr(g) - sqr(sq)) / (2.0 * g + torch.where(gz, 0.0, 1.0))
    ct_iso = 1.0 - 2.0 * u[..., 0]
    ct = torch.where(gz, ct_g, ct_iso)
    st = safe_sqrt(1.0 - sqr(ct))
    phi = 2.0 * math.pi * u[..., 1]
    wi = Frame.from_z(wo).from_local(vec(st * torch.cos(phi), st * torch.sin(phi), ct))
    return wi, henyey_greenstein(ct, g)
