"""Monte Carlo warps (port of ``shimmer_tpu/ops/sampling.py``: the warps
the forward render path and its materials use).  Expressions keep the
reference's operand order so that float32 rounding matches it."""

from __future__ import annotations

import math

import torch

from shimmer_tpu_torch.ops.math import (
    difference_of_products,
    lerp,
    safe_sqrt,
    sqr,
    sqrt,
    sum_of_products,
)
from shimmer_tpu_torch.ops.vecmath import (
    angle_between,
    cross,
    dot,
    gram_schmidt,
    length_squared,
    normalize,
    vec,
    vec2,
)

INV_PI = 1.0 / math.pi
INV_2PI = 1.0 / (2.0 * math.pi)
INV_4PI = 1.0 / (4.0 * math.pi)
PI_OVER_2 = math.pi / 2.0
PI_OVER_4 = math.pi / 4.0
UNIFORM_SPHERE_PDF = INV_4PI
UNIFORM_HEMISPHERE_PDF = INV_2PI


def balance_heuristic(nf, f_pdf, ng, g_pdf):
    return (nf * f_pdf) / (nf * f_pdf + ng * g_pdf)


def power_heuristic(nf, f_pdf, ng, g_pdf):
    f = nf * f_pdf
    g = ng * g_pdf
    f2 = sqr(f)
    denom = f2 + sqr(g)
    pos = denom > 0.0
    w = torch.where(pos, f2 / torch.where(pos, denom, torch.ones_like(denom)), 0.0)
    return torch.where(torch.isinf(f2), 1.0, w)


def sample_discrete(weights, u):
    """Index from unnormalized weights along the last axis.
    Returns (index, pmf, u_remapped)."""
    total = torch.sum(weights, dim=-1, keepdim=True)
    safe_total = torch.where(total == 0.0, torch.ones_like(total), total)
    cdf = torch.cumsum(weights, dim=-1) / safe_total
    idx = torch.sum((u[..., None] >= cdf).to(torch.int64), dim=-1)
    n = weights.shape[-1]
    idx = torch.clamp(idx, 0, n - 1)
    pmf = torch.gather(weights, -1, idx[..., None])[..., 0] / safe_total[..., 0]
    lo = torch.where(
        idx == 0,
        0.0,
        torch.gather(cdf, -1, torch.clamp(idx - 1, min=0)[..., None])[..., 0],
    )
    hi = torch.gather(cdf, -1, idx[..., None])[..., 0]
    u_remap = torch.clamp(
        (u - lo) / torch.where(hi == lo, torch.ones_like(hi), hi - lo), 0.0, 1.0
    )
    return idx, pmf, u_remap


def sample_exponential(u, a):
    return -torch.log1p(-u) / a


def exponential_pdf(x, a):
    return a * torch.exp(-a * x)


def sample_uniform_sphere(u):
    z = 1.0 - 2.0 * u[..., 0]
    r = safe_sqrt(1.0 - sqr(z))
    phi = 2.0 * math.pi * u[..., 1]
    return vec(r * torch.cos(phi), r * torch.sin(phi), z)


def sample_uniform_hemisphere(u):
    z = u[..., 0]
    r = safe_sqrt(1.0 - sqr(z))
    phi = 2.0 * math.pi * u[..., 1]
    return vec(r * torch.cos(phi), r * torch.sin(phi), z)


def sample_uniform_disk_concentric(u):
    """Shirley-Chiu concentric disk mapping."""
    uo = 2.0 * u - 1.0
    x, y = uo[..., 0], uo[..., 1]
    zero = (x == 0.0) & (y == 0.0)
    use_x = torch.abs(x) > torch.abs(y)
    r = torch.where(use_x, x, y)

    def safe(v):
        return torch.where(v == 0.0, torch.ones_like(v), v)

    theta = torch.where(
        use_x, PI_OVER_4 * (y / safe(x)), PI_OVER_2 - PI_OVER_4 * (x / safe(y))
    )
    p = r[..., None] * vec2(torch.cos(theta), torch.sin(theta))
    return torch.where(zero[..., None], 0.0, p)


def sample_uniform_disk_polar(u):
    r = sqrt(u[..., 0])
    theta = 2.0 * math.pi * u[..., 1]
    return r[..., None] * vec2(torch.cos(theta), torch.sin(theta))


def sample_cosine_hemisphere(u):
    d = sample_uniform_disk_concentric(u)
    z = safe_sqrt(1.0 - length_squared(d))
    return torch.cat([d, z[..., None]], dim=-1)


def cosine_hemisphere_pdf(cos_theta):
    return cos_theta * INV_PI


def sample_uniform_triangle(u):
    """Barycentrics uniform over a triangle."""
    u0, u1 = u[..., 0], u[..., 1]
    flip = u0 < u1
    b0 = torch.where(flip, u0 / 2.0, u0 - u1 / 2.0)
    b1 = torch.where(flip, u1 - b0, u1 / 2.0)
    return torch.stack([b0, b1, 1.0 - b0 - b1], dim=-1)


def sample_spherical_triangle(v0, v1, v2, p, u):
    """Uniform solid-angle sampling of a spherical triangle (Arvo 1995 via
    pbrt).  Returns (barycentrics (..., 3), pdf = 1/solid_angle)."""
    a = normalize(v0 - p)
    b = normalize(v1 - p)
    c = normalize(v2 - p)
    n_ab = cross(a, b)
    n_bc = cross(b, c)
    n_ca = cross(c, a)
    bad = (
        (length_squared(n_ab) == 0.0)
        | (length_squared(n_bc) == 0.0)
        | (length_squared(n_ca) == 0.0)
    )
    n_ab_n = normalize(n_ab)
    n_bc_n = normalize(n_bc)
    n_ca_n = normalize(n_ca)
    alpha = angle_between(n_ab_n, -n_ca_n)
    beta = angle_between(n_bc_n, -n_ab_n)
    gamma = angle_between(n_ca_n, -n_bc_n)
    a_pi = alpha + beta + gamma
    solid = a_pi - math.pi
    pdf = torch.where(
        bad | (solid <= 0.0),
        0.0,
        1.0 / torch.where(solid <= 0.0, torch.ones_like(solid), solid),
    )

    ap_pi = lerp(u[..., 0], math.pi, a_pi)
    cos_alpha = torch.cos(alpha)
    sin_alpha = torch.sin(alpha)
    sin_phi = torch.sin(ap_pi) * cos_alpha - torch.cos(ap_pi) * sin_alpha
    cos_phi = torch.cos(ap_pi) * cos_alpha + torch.sin(ap_pi) * sin_alpha
    k1 = cos_phi + cos_alpha
    k2 = sin_phi - sin_alpha * dot(a, b)
    cos_bp = (k2 + (difference_of_products(k2, cos_phi, k1, sin_phi)) * cos_alpha) / (
        (sum_of_products(k2, sin_phi, k1, cos_phi)) * sin_alpha
    )
    cos_bp = torch.clamp(cos_bp, -1.0, 1.0)
    sin_bp = safe_sqrt(1.0 - sqr(cos_bp))
    cp = cos_bp[..., None] * a + sin_bp[..., None] * normalize(gram_schmidt(c, a))
    cos_theta = 1.0 - u[..., 1] * (1.0 - dot(cp, b))
    sin_theta = safe_sqrt(1.0 - sqr(cos_theta))
    w = cos_theta[..., None] * b + sin_theta[..., None] * normalize(
        gram_schmidt(cp, b)
    )
    e1 = v1 - v0
    e2 = v2 - v0
    s1 = cross(w, e2)
    div = dot(s1, e1)
    div_ok = torch.abs(div) > 1e-20
    inv_div = 1.0 / torch.where(div_ok, div, torch.ones_like(div))
    s = p - v0
    b1 = torch.clamp(dot(s, s1) * inv_div, 0.0, 1.0)
    b2 = torch.clamp(dot(cross(s, e1), w) * inv_div, 0.0, 1.0)
    denom = b1 + b2
    over = denom > 1.0
    denom_safe = torch.where(over, denom, torch.ones_like(denom))
    b1 = torch.where(over, b1 / denom_safe, b1)
    b2 = torch.where(over, b2 / denom_safe, b2)
    bary = torch.stack([1.0 - b1 - b2, b1, b2], dim=-1)
    third = torch.full_like(bary, 1.0 / 3.0)
    return torch.where(div_ok[..., None], bary, third), pdf


def sample_visible_wavelengths(u):
    """Importance-sample visible wavelengths (pbrt sech^2 weighting)."""
    return 538.0 - 138.888889 * torch.atanh(0.85691062 - 1.82750197 * u)


def visible_wavelengths_pdf(lam):
    x = torch.cosh(0.0072 * (lam - 538.0))
    pdf = 0.0039398042 / sqr(x)
    return torch.where((lam >= 360.0) & (lam <= 830.0), pdf, 0.0)
