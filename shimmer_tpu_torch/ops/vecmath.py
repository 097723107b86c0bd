"""Batched 2/3-vector geometry on ``(..., 2|3)`` tensors (port of
``shimmer_tpu/ops/vecmath.py``)."""

from __future__ import annotations

import dataclasses
import math

import torch

from shimmer_tpu_torch.ops.math import difference_of_products, safe_sqrt, sqr


def vec(x, y, z):
    return torch.stack([x, y, z], dim=-1)


def vec2(x, y):
    return torch.stack([x, y], dim=-1)


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def abs_dot(a, b):
    return torch.abs(dot(a, b))


def cross(a, b):
    """Cross product with difference_of_products components."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [
            difference_of_products(ay, bz, az, by),
            difference_of_products(az, bx, ax, bz),
            difference_of_products(ax, by, ay, bx),
        ],
        dim=-1,
    )


def length_squared(v):
    return dot(v, v)


def length(v):
    return safe_sqrt(length_squared(v))


def normalize(v):
    """v / |v|; v unchanged where |v| == 0."""
    l2 = torch.sum(v * v, dim=-1)
    ok = l2 > 0.0
    inv = torch.rsqrt(torch.where(ok, l2, torch.ones_like(l2)))
    return v * torch.where(ok, inv, 1.0)[..., None]


def distance_squared(p, q):
    return length_squared(p - q)


def face_forward(n, v):
    """Flip n into the hemisphere of v."""
    return torch.where(dot(n, v)[..., None] < 0.0, -n, n)


def coordinate_system(v1):
    """Branchless orthonormal basis from a unit vector (Duff et al. 2017)."""
    z = v1[..., 2]
    sign = torch.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = v1[..., 0] * v1[..., 1] * a
    v2 = torch.stack(
        [1.0 + sign * sqr(v1[..., 0]) * a, sign * b, -sign * v1[..., 0]], dim=-1
    )
    v3 = torch.stack([b, sign + sqr(v1[..., 1]) * a, -v1[..., 1]], dim=-1)
    return v2, v3


def gram_schmidt(v, w):
    return v - dot(v, w)[..., None] * w


def angle_between(a, b):
    """Numerically stable angle between unit vectors."""
    cond = dot(a, b) < 0.0
    small = torch.where(cond[..., None], a + b, b - a)
    half = 2.0 * torch.asin(torch.clamp(length(small) / 2.0, -1.0, 1.0))
    return torch.where(cond, math.pi - half, half)


def abs_cos_theta(w):
    return torch.abs(w[..., 2])


def same_hemisphere(w, wp):
    return w[..., 2] * wp[..., 2] > 0.0


def spherical_triangle_area(a, b, c):
    """Solid angle of a spherical triangle (Van Oosterom & Strackee)."""
    return torch.abs(
        2.0
        * torch.atan2(
            dot(a, cross(b, c)), 1.0 + dot(a, b) + dot(a, c) + dot(b, c)
        )
    )


@dataclasses.dataclass(frozen=True)
class Frame:
    """Orthonormal basis, batched over the leading dims of x/y/z."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @staticmethod
    def from_z(z):
        x, y = coordinate_system(z)
        return Frame(x=x, y=y, z=z)

    @staticmethod
    def from_xz(x, z):
        return Frame(x=x, y=cross(z, x), z=z)

    def to_local(self, v):
        return torch.stack([dot(v, self.x), dot(v, self.y), dot(v, self.z)], dim=-1)

    def from_local(self, v):
        return v[..., 0:1] * self.x + v[..., 1:2] * self.y + v[..., 2:3] * self.z
