"""Scalar math helpers, vectorized over tensors (port of
``shimmer_tpu/ops/math.py``: the pieces the forward render path uses).

The reference's ``safe_sqrt`` carries a custom JVP for the
differentiable renderer; the forward port needs only its value.
"""

from __future__ import annotations

import torch


def sqr(x):
    return x * x


def lerp(t, a, b):
    """(1-t)*a + t*b."""
    return (1.0 - t) * a + t * b


def safe_sqrt(x):
    """sqrt clamped to non-negative input."""
    return torch.sqrt(torch.clamp(x, min=0.0))


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


def take_clamped(table, idx):
    """``table[idx]`` with out-of-range ids clamped into the table, the
    gather semantics of the reference's ``small_gather`` (miss lanes carry
    id -1 and read row 0)."""
    k = table.shape[0]
    return table[torch.clamp(idx.long(), 0, k - 1)]
