"""Monte Carlo warps and piecewise-constant distributions (port of
``shimmer_tpu/ops/sampling.py``: the warps the forward render path, its
materials and the bilinear patches use, and the 1-D / 2-D tables the image
environment light samples).  Expressions keep the reference's operand
order so that float32 rounding matches it.

The distributions' CDFs are built on the host with :func:`xla_cumsum`,
which adds in the order the reference's cumsum adds on the CPU, so the
tables are bit-equal.  A 2-D sample finds its column by a binary search
over the chosen row (log2 W gathers per lane) instead of gathering the
whole row per lane as the reference does; each row is nondecreasing, so
the index is the same.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from benchmark.reference.frozen.config import resolve_device
from benchmark.reference.frozen.ops.math import (
    difference_of_products,
    find_interval,
    lerp,
    safe_sqrt,
    sqr,
    sqrt,
    sum_of_products,
    to_i32,
)
from benchmark.reference.frozen.ops.vecmath import (
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


def sample_tent(u, r):
    """Tent filter sample over [-r, r]."""
    take_neg = u < 0.5
    u1 = torch.where(take_neg, u * 2.0, (u - 0.5) * 2.0)
    x = sample_linear(u1, torch.ones_like(u1), torch.zeros_like(u1))
    return torch.where(take_neg, -r * (1.0 - x), r * (1.0 - x))


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


def sample_linear(u, a, b):
    """x in [0, 1) with density proportional to lerp(x, a, b)."""
    zero = (a == 0.0) & (b == 0.0)
    denom = a + sqrt(lerp(u, sqr(a), sqr(b)))
    x = u * (a + b) / torch.where(denom == 0.0, torch.ones_like(denom), denom)
    x = torch.where(zero, u, x)
    return torch.minimum(x, torch.tensor(1.0 - 1e-7, dtype=x.dtype, device=x.device))


def linear_pdf(x, a, b):
    inside = (x >= 0.0) & (x <= 1.0)
    return torch.where(inside, 2.0 * lerp(x, a, b) / (a + b), 0.0)


def invert_linear_sample(x, a, b):
    return x * (a * (2.0 - x) + b * x) / (a + b)


def sample_bilinear(u, w):
    """(u, v) with density proportional to the bilinear interpolation of
    the corner weights ``w`` (..., 4), laid out [w00, w10, w01, w11]."""
    w00, w10, w01, w11 = w[..., 0], w[..., 1], w[..., 2], w[..., 3]
    v = sample_linear(u[..., 1], w00 + w10, w01 + w11)
    uo = sample_linear(u[..., 0], lerp(v, w00, w01), lerp(v, w10, w11))
    return vec2(uo, v)


def bilinear_pdf(p, w):
    w00, w10, w01, w11 = w[..., 0], w[..., 1], w[..., 2], w[..., 3]
    total = w00 + w10 + w01 + w11
    u, v = p[..., 0], p[..., 1]
    inside = (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1)
    f = (1 - u) * (1 - v) * w00 + u * (1 - v) * w10 + (1 - u) * v * w01 + u * v * w11
    flat = total <= 0.0
    pdf = torch.where(flat, 1.0, 4.0 * f / torch.where(flat, torch.ones_like(total), total))
    return torch.where(inside, pdf, 0.0)


def invert_bilinear_sample(p, w):
    w00, w10, w01, w11 = w[..., 0], w[..., 1], w[..., 2], w[..., 3]
    v = invert_linear_sample(p[..., 1], w00 + w10, w01 + w11)
    u = invert_linear_sample(p[..., 0], lerp(v, w00, w01), lerp(v, w10, w11))
    return vec2(u, v)


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


# --- piecewise-constant distributions ---

# Block length of the reference's cumsum on the CPU: the scan runs in
# blocks of 16 from a zero start, and the blocks' totals are scanned the
# same way, recursively, then added to every block.
_SCAN_BLOCK = 16


def _sequential_cumsum(x):
    out = torch.empty_like(x)
    acc = torch.zeros_like(x[..., 0])
    for k in range(x.shape[-1]):
        acc = acc + x[..., k]
        out[..., k] = acc
    return out


def xla_cumsum(x):
    """Inclusive float32 cumsum along the last axis in the order the
    reference's cumsum adds on the CPU (``torch.cumsum`` accumulates in
    float64 there and differs by a few ulps)."""
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        return _sequential_cumsum(x)
    m = -(-n // _SCAN_BLOCK)
    xp = torch.nn.functional.pad(x, (0, m * _SCAN_BLOCK - n))
    within = _sequential_cumsum(xp.reshape(x.shape[:-1] + (m, _SCAN_BLOCK)))
    before = torch.nn.functional.pad(xla_cumsum(within[..., -1])[..., :-1], (1, 0))
    return (within + before[..., None]).reshape(x.shape[:-1] + (m * _SCAN_BLOCK,))[..., :n]


def _first_above(flat, start, width: int, u):
    """Per lane, the count of k in [1, width] with flat[start + k] <= u, for
    nondecreasing rows: a binary search with log2(width + 1) gathers."""
    lo = torch.ones_like(start)
    hi = torch.full_like(start, width + 1)
    for _ in range(max(1, math.ceil(math.log2(width + 1)))):
        active = lo < hi
        mid = (lo + hi) // 2
        above = flat[start + torch.clamp(mid, max=width)] > u
        hi = torch.where(active & above, mid, hi)
        lo = torch.where(active & ~above, mid + 1, lo)
    return lo - 1


@dataclasses.dataclass(frozen=True)
class PiecewiseConstant1D:
    """Tabulated 1-D distribution over [domain_min, domain_max]: func
    (..., N) >= 0, cdf (..., N + 1), func_int (...,)."""

    func: torch.Tensor
    cdf: torch.Tensor
    func_int: torch.Tensor
    domain_min: float = 0.0
    domain_max: float = 1.0

    @property
    def size(self):
        return self.func.shape[-1]

    def sample(self, u):
        """Returns (x, pdf, offset)."""
        n = self.size
        if self.cdf.ndim == 1:
            o = find_interval(self.cdf, u)
            cdf_o = self.cdf[o]
            cdf_o1 = self.cdf[o + 1]
            f_o = self.func[o]
        else:
            o = torch.searchsorted(self.cdf[..., 1:].contiguous(), u[..., None].contiguous(),
                                   right=True)
            o = torch.clamp(o, 0, n - 1)
            cdf_o = torch.gather(self.cdf, -1, o)[..., 0]
            cdf_o1 = torch.gather(self.cdf, -1, o + 1)[..., 0]
            f_o = torch.gather(self.func, -1, o)[..., 0]
            o = o[..., 0]
        integral = self.func_int
        du = u - cdf_o
        width = cdf_o1 - cdf_o
        du = torch.where(width > 0.0, du / torch.where(width > 0.0, width, 1.0), du)
        pos = integral > 0.0
        pdf = torch.where(pos, f_o / torch.where(pos, integral, 1.0), 0.0)
        x = lerp((o.to(torch.float32) + du) / n, self.domain_min, self.domain_max)
        return x, pdf, o

    def pdf_at(self, x):
        n = self.size
        t = (x - self.domain_min) / (self.domain_max - self.domain_min)
        i = torch.clamp(to_i32(t * n), 0, n - 1).long()
        if self.func.ndim == 1:
            f = self.func[i]
        else:
            f = torch.gather(self.func, -1, i[..., None])[..., 0]
        pos = self.func_int > 0.0
        return torch.where(pos, f / torch.where(pos, self.func_int, 1.0), 0.0)


def build_piecewise_constant_1d(func, domain_min=0.0, domain_max=1.0, device=None):
    """A PiecewiseConstant1D from (..., N) values, built on the host and
    placed on ``device`` (default: the CUDA card); a row of zeros becomes
    uniform."""
    device = resolve_device(device)
    func = torch.abs(torch.as_tensor(func, dtype=torch.float32, device="cpu"))
    n = func.shape[-1]
    step = (domain_max - domain_min) / n
    cdf = xla_cumsum(func * step)
    func_int = cdf[..., -1]
    zero = func_int == 0.0
    ramp = torch.arange(1, n + 1, dtype=torch.float32) / n
    norm_cdf = torch.where(zero[..., None], ramp,
                           cdf / torch.where(zero[..., None], 1.0, func_int[..., None]))
    cdf_full = torch.cat([torch.zeros_like(norm_cdf[..., :1]), norm_cdf], dim=-1)
    return PiecewiseConstant1D(
        func=torch.where(zero[..., None], torch.ones_like(func), func).to(device),
        cdf=cdf_full.to(device),
        func_int=torch.where(zero, step * n, func_int).to(device),
        domain_min=float(domain_min),
        domain_max=float(domain_max),
    )


@dataclasses.dataclass(frozen=True)
class PiecewiseConstant2D:
    """2-D distribution: a marginal over rows and a conditional per row;
    func is (H, W)."""

    func: torch.Tensor        # (H, W)
    cond_cdf: torch.Tensor    # (H, W + 1) conditional CDFs p(u | v)
    cond_int: torch.Tensor    # (H,) row integrals
    marg_cdf: torch.Tensor    # (H + 1,)
    marg_func: torch.Tensor   # (H,)
    marg_int: torch.Tensor    # ()
    domain: tuple = ((0.0, 0.0), (1.0, 1.0))

    def sample(self, u):
        """u (..., 2) -> (point (..., 2), pdf)."""
        (x0, y0), (x1, y1) = self.domain
        h, w = self.func.shape
        # The marginal over rows (v).
        uv = u[..., 1]
        ov = torch.clamp(torch.searchsorted(self.marg_cdf, uv.contiguous(), right=True) - 1,
                         0, h - 1)
        c0 = self.marg_cdf[ov]
        c1 = self.marg_cdf[ov + 1]
        rising = c1 > c0
        dv = torch.where(rising, (uv - c0) / torch.where(rising, c1 - c0, 1.0), 0.0)
        pdf_v = torch.where(self.marg_int > 0.0, self.marg_func[ov] / self.marg_int, 0.0)
        v = (ov.to(torch.float32) + dv) / h
        # The conditional over columns (u) of the chosen row.
        uu = u[..., 0]
        flat = self.cond_cdf.reshape(-1)
        start = ov * (w + 1)
        ou = torch.clamp(_first_above(flat, start, w, uu), 0, w - 1)
        c0u = flat[start + ou]
        c1u = flat[start + ou + 1]
        rising = c1u > c0u
        du = torch.where(rising, (uu - c0u) / torch.where(rising, c1u - c0u, 1.0), 0.0)
        row_int = self.cond_int[ov]
        f = self.func[ov, ou]
        pos = row_int > 0.0
        pdf_u = torch.where(pos, f / torch.where(pos, row_int, 1.0), 0.0)
        x = lerp((ou.to(torch.float32) + du) / w, x0, x1)
        y = lerp(v, y0, y1)
        pdf = pdf_u * pdf_v / ((x1 - x0) * (y1 - y0))
        return vec2(x, y), pdf

    def pdf_at(self, p):
        (x0, y0), (x1, y1) = self.domain
        h, w = self.func.shape
        tx = (p[..., 0] - x0) / (x1 - x0)
        ty = (p[..., 1] - y0) / (y1 - y0)
        ix = torch.clamp(to_i32(tx * w), 0, w - 1).long()
        iy = torch.clamp(to_i32(ty * h), 0, h - 1).long()
        f = self.func[iy, ix]
        pos = self.marg_int > 0.0
        return torch.where(pos, f / torch.where(pos, self.marg_int, 1.0), 0.0) / (
            (x1 - x0) * (y1 - y0)
        )

    @property
    def integral(self):
        return self.marg_int


def build_piecewise_constant_2d(func, domain=((0.0, 0.0), (1.0, 1.0)), device=None):
    """A PiecewiseConstant2D from (H, W) values, built on the host and
    placed on ``device`` (default: the CUDA card)."""
    device = resolve_device(device)
    func = torch.abs(torch.as_tensor(func, dtype=torch.float32, device="cpu"))
    h, w = func.shape
    (x0, y0), (x1, y1) = domain
    du = (x1 - x0) / w
    dv = (y1 - y0) / h
    cond_cdf = xla_cumsum(func * du)
    cond_int = cond_cdf[:, -1]
    zero_row = cond_int == 0.0
    ramp = torch.broadcast_to(torch.arange(1, w + 1, dtype=torch.float32) / w, (h, w))
    cond_norm = torch.where(zero_row[:, None], ramp,
                            cond_cdf / torch.where(zero_row[:, None], 1.0, cond_int[:, None]))
    cond_full = torch.cat([torch.zeros((h, 1), dtype=torch.float32), cond_norm], dim=-1)
    marg_func = cond_int
    marg_cdf = xla_cumsum(marg_func * dv)
    marg_int = marg_cdf[-1]
    zero = marg_int == 0.0
    marg_ramp = torch.arange(1, h + 1, dtype=torch.float32) / h
    marg_norm = torch.where(zero, marg_ramp, marg_cdf / torch.where(zero, 1.0, marg_int))
    marg_full = torch.cat([torch.zeros(1, dtype=torch.float32), marg_norm])
    return PiecewiseConstant2D(
        func=func.to(device),
        cond_cdf=cond_full.to(device),
        cond_int=torch.where(zero_row, du * w, cond_int).to(device),
        marg_cdf=marg_full.to(device),
        marg_func=torch.where(zero, torch.ones_like(marg_func) * dv * w, marg_func).to(device),
        marg_int=torch.where(zero, dv * h * du * w, marg_int).to(device),
        domain=tuple(map(tuple, domain)),
    )
