"""Scalar math helpers, vectorized over tensors (port of
``shimmer_tpu/ops/math.py``).

``safe_sqrt``, ``safe_asin`` and ``safe_acos`` are autograd Functions
with the reference's custom derivatives: clamped near the edges of their
domain and zero beyond them, so masked dead lanes cannot poison a
gradient with 0 * inf = NaN.  Their values are the plain clamped ones.
"""

from __future__ import annotations

import math

import torch

from shimmer_tpu_torch.ops.gather import gather_rows


def sqr(x):
    return x * x


def lerp(t, a, b):
    """(1-t)*a + t*b."""
    return (1.0 - t) * a + t * b


def sqrt(x):
    """Correctly rounded float32 square root, as CUDA's and the
    reference's are.  torch's vectorized CPU kernel is off by an ulp on
    about 0.7% of inputs, and the Fresnel and microfacet formulas amplify
    that through cancellation, so on the CPU the root is taken in float64
    and rounded once (exact for a square root)."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


class _SafeSqrt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = sqrt(torch.clamp(x, min=0.0))
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return g * torch.where(x > 1e-12, 0.5 / torch.clamp(y, min=1e-12), 0.0)


class _SafeArc(torch.autograd.Function):
    """asin / acos of the input clamped to [-1, 1]; the derivative is
    +-1 / sqrt(max(1 - xc^2, 1e-12)) inside |x| < 1 - 1e-7 and 0 outside."""

    @staticmethod
    def forward(ctx, x, sign):
        xc = torch.clamp(x, -1.0, 1.0)
        ctx.save_for_backward(x)
        ctx.sign = sign
        return torch.asin(xc) if sign > 0 else torch.acos(xc)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        xc = torch.clamp(x, -1.0, 1.0)
        denom = sqrt(torch.clamp(1.0 - xc * xc, min=1e-12))
        inside = torch.abs(x) < 1.0 - 1e-7
        return torch.where(inside, ctx.sign * g / denom, 0.0), None


def stop_gradient(x):
    """``x`` cut from the autograd graph (``x.detach()``); a number passes
    through unchanged."""
    return x.detach() if isinstance(x, torch.Tensor) else x


def safe_sqrt(x):
    """sqrt clamped to non-negative input; derivative 0.5 / max(y, 1e-12)
    where x > 1e-12, else 0."""
    return _SafeSqrt.apply(x)


def safe_asin(x):
    """asin clamped to [-1, 1]."""
    return _SafeArc.apply(x, 1.0)


def safe_acos(x):
    """acos clamped to [-1, 1]."""
    return _SafeArc.apply(x, -1.0)


def safe_div(a, b):
    """a/b with 0 where b == 0."""
    nz = b != 0.0
    return torch.where(nz, a / torch.where(nz, b, torch.ones_like(b)), 0.0)


def difference_of_products(a, b, c, d):
    """a*b - c*d with the reference's error-correction term.

    Evaluated op by op in float32, so nothing is fused into an FMA: the
    traversal kernel (csrc/traverse_body.cuh) is built with -fmad=false to
    compute the same bits."""
    cd = c * d
    diff = a * b - cd
    err = -c * d + cd
    return diff + err


def sum_of_products(a, b, c, d):
    cd = c * d
    s = a * b + cd
    err = c * d - cd
    return s + err


def quadratic(a, b, c):
    """Solve a*t^2 + b*t + c = 0 robustly: (has_solution, t0, t1) with
    t0 <= t1, the discriminant by difference_of_products and the stable
    q form; b == 0 takes the positive sign and a == 0 the linear root."""
    disc = difference_of_products(b, b, 4.0 * a, c)
    has = (disc >= 0.0) & (a != 0.0)
    root = safe_sqrt(disc)
    q = -0.5 * (b + torch.sign(b) * root)
    q = torch.where(b == 0.0, -0.5 * root, q)
    a_safe = torch.where(a != 0.0, a, torch.ones_like(a))
    q_safe = torch.where(q != 0.0, q, torch.ones_like(q))
    t0 = q / a_safe
    t1 = torch.where(q != 0.0, c / q_safe, t0)
    lo = torch.minimum(t0, t1)
    hi = torch.maximum(t0, t1)
    lin_ok = (a == 0.0) & (b != 0.0)
    b_safe = torch.where(b != 0.0, b, torch.ones_like(b))
    t_lin = -c / b_safe
    has = has | lin_ok
    lo = torch.where(lin_ok, t_lin, lo)
    hi = torch.where(lin_ok, t_lin, hi)
    return has, lo, hi


def fma(a, b, c):
    """a * b + c rounded once to float32 (the product of two float32 is
    exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def dot_lanes(terms):
    """sum of a_k * b_k over (a, b) pairs as the reference's CPU
    contraction adds a batched or broadcast matrix-vector product: the
    first product rounded, then one fused multiply-add per term."""
    (a0, b0), *rest = terms
    acc = a0 * b0
    for a, b in rest:
        acc = fma(a, b, acc)
    return acc


def sinc(x):
    """Normalized sinc sin(pi x) / (pi x), 1 near 0."""
    px = math.pi * x
    small = torch.abs(x) < 1e-5
    px_safe = torch.where(small, 1.0, px)
    return torch.where(small, 1.0, torch.sin(px_safe) / px_safe)


def windowed_sinc(x, radius, tau):
    """Lanczos-windowed sinc, 0 beyond ``radius``."""
    out = sinc(x) * sinc(x / tau)
    return torch.where(torch.abs(x) > radius, 0.0, out)


def erf_inv(x):
    return torch.erfinv(x)


def to_i32(x):
    """float -> int32 as the reference converts: toward zero, saturating
    at the int32 range, NaN -> 0 (a plain ``.to(torch.int32)`` is
    undefined out of range)."""
    x = torch.where(torch.isnan(x), 0.0, x)
    x = torch.clamp(x, -2147483648.0, 2147483648.0).to(torch.int64)
    return torch.clamp(x, -2147483648, 2147483647).to(torch.int32)


def find_interval(xs, x):
    """Index i with xs[i] <= x < xs[i+1], clamped to [0, n-2], for a sorted
    1-D knot array ``xs`` and ``x`` of any shape."""
    n = xs.shape[-1]
    idx = torch.searchsorted(xs, x.contiguous(), right=True) - 1
    return torch.clamp(idx, 0, n - 2)


def smooth_step(x, a, b):
    """Hermite smoothstep of x on [a, b]."""
    t = torch.clamp(safe_div(x - a, b - a), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def take_clamped(table, idx):
    """``table[idx]`` with out-of-range ids clamped into the table: a plain
    gather for ids that are valid or whose lanes are masked.  Material-id
    gathers that must read the reference's row use ``small_gather``.  Its
    backward is ``ops.gather.gather_rows``'s."""
    k = table.shape[0]
    return gather_rows(table, torch.clamp(idx.long(), 0, k - 1))


def take_wrapped(table, idx):
    """``table[idx]`` with the reference's plain indexing: a negative id
    counts from the end, then ids are clamped into the table (a lane that
    reads a row it then discards never faults).  Its backward is
    ``ops.gather.gather_rows``'s."""
    k = table.shape[0]
    idx = idx.long()
    return gather_rows(table, torch.clamp(torch.where(idx < 0, idx + k, idx), 0, k - 1))


# The reference's ``small_gather`` clamps ids into tables of up to this
# many rows and indexes plainly beyond (shimmer_tpu/ops/math.py:222-244).
SMALL_GATHER_ROWS = 32


def small_gather(table, idx):
    """``table[idx]`` with the reference's ``small_gather`` semantics: a
    table of at most SMALL_GATHER_ROWS rows clamps the ids into it, a larger
    one indexes plainly (a negative id counts from the end).  Material-less
    lanes carry id -1 and read a row they then discard; which row depends
    on the table's size, as in the reference."""
    if table.shape[0] > SMALL_GATHER_ROWS:
        return take_wrapped(table, idx)
    return take_clamped(table, idx)
