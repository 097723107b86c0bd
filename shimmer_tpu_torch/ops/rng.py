"""Counter-based, stateless RNG primitives (port of ``shimmer_tpu/ops/rng.py``).

The reference hashes in uint32 with wraparound multiplies and logical
right shifts.  torch has no general uint32 arithmetic and its ``>>`` on
signed types is arithmetic, so a uint32 word is held here in an int64
tensor with its value in [0, 2^32): shifts of non-negative values are
logical, and every multiply is split into 16-bit halves (:func:`mul32`) so
no int64 product overflows.  The streams are bit-exact against the
reference.
"""

from __future__ import annotations

import torch

from shimmer_tpu_torch.config import ONE_MINUS_EPSILON

MASK32 = 0xFFFFFFFF


def u32(x, device=None) -> torch.Tensor:
    """Any integer tensor / int -> the int64 uint32 carrier."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, device=device)
    return x.to(torch.int64) & MASK32


def mul32(a, b):
    """(a * b) mod 2^32 for uint32 words a (tensor) and b (tensor or int)."""
    b_lo = b & 0xFFFF
    b_hi = b >> 16
    return (a * b_lo + (((a * b_hi) & 0xFFFF) << 16)) & MASK32


def add32(a, b):
    return (a + b) & MASK32


def pcg_hash(x):
    """pcg32-style permutation of a uint32 word."""
    x = u32(x)
    state = add32(mul32(x, 747796405), 2891336453)
    word = mul32(((state >> ((state >> 28) + 4)) ^ state), 277803737)
    return (word >> 22) ^ word


def hash_combine(*xs):
    """Mix several uint32 words into one (boost-style combine + pcg)."""
    h = 0x9E3779B9
    for x in xs:
        x = x & MASK32 if isinstance(x, int) else u32(x)
        h = pcg_hash(x ^ h)
    return h


def pcg3d(v0, v1, v2):
    """3-in/3-out hash (Jarzynski & Olano pcg3d)."""
    x, y, z = u32(v0), u32(v1), u32(v2)
    x = add32(mul32(x, 1664525), 1013904223)
    y = add32(mul32(y, 1664525), 1013904223)
    z = add32(mul32(z, 1664525), 1013904223)
    x = add32(x, mul32(y, z))
    y = add32(y, mul32(z, x))
    z = add32(z, mul32(x, y))
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    x = add32(x, mul32(y, z))
    y = add32(y, mul32(z, x))
    z = add32(z, mul32(x, y))
    return x, y, z


def u32_to_unit_float(u):
    """uint32 -> float32 in [0, 1) from the top 24 bits (exact)."""
    f = (u32(u) >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return torch.clamp(f, max=ONE_MINUS_EPSILON)

