"""Batched 2/3-vector geometry on ``(..., 2|3)`` tensors (port of
``shimmer_tpu/ops/vecmath.py``)."""

from __future__ import annotations

import dataclasses
import math

import torch

from benchmark.reference.frozen.ops.math import difference_of_products, safe_acos, safe_sqrt, sqr, sqrt


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


def spherical_theta(v):
    return safe_acos(v[..., 2])


def spherical_phi(v):
    """atan2(y, x) in [0, 2 pi)."""
    p = torch.atan2(v[..., 1], v[..., 0])
    return torch.where(p < 0.0, p + 2.0 * math.pi, p)


def cos_theta(w):
    return w[..., 2]


def cos2_theta(w):
    return sqr(w[..., 2])


def abs_cos_theta(w):
    return torch.abs(w[..., 2])


def sin2_theta(w):
    return torch.clamp(1.0 - cos2_theta(w), min=0.0)


def sin_theta(w):
    return sqrt(sin2_theta(w))


def tan2_theta(w):
    """sin^2 / cos^2; inf where cos == 0 (callers mask on isfinite)."""
    c2 = cos2_theta(w)
    ok = c2 > 0.0
    return torch.where(ok, sin2_theta(w) / torch.where(ok, c2, torch.ones_like(c2)), float("inf"))


def cos_phi(w):
    s = sin_theta(w)
    zero = s == 0.0
    return torch.where(
        zero, 1.0, torch.clamp(w[..., 0] / torch.where(zero, torch.ones_like(s), s), -1.0, 1.0)
    )


def sin_phi(w):
    s = sin_theta(w)
    zero = s == 0.0
    return torch.where(
        zero, 0.0, torch.clamp(w[..., 1] / torch.where(zero, torch.ones_like(s), s), -1.0, 1.0)
    )


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


# --- equal-area octahedral maps (Clarberg 2008) ---


def equal_area_square_to_sphere(p):
    """[0, 1]^2 -> the unit sphere, equal-area octahedral."""
    u = 2.0 * p[..., 0] - 1.0
    v = 2.0 * p[..., 1] - 1.0
    up = torch.abs(u)
    vp = torch.abs(v)
    sd = 1.0 - (up + vp)
    d = torch.abs(sd)
    r = 1.0 - d
    r_zero = r == 0.0
    phi = torch.where(r_zero, 1.0, (vp - up) / torch.where(r_zero, 1.0, r) + 1.0) * (
        math.pi / 4.0
    )
    z = torch.copysign(1.0 - sqr(r), sd)
    cos_p = torch.copysign(torch.cos(phi), u)
    sin_p = torch.copysign(torch.sin(phi), v)
    scale = r * safe_sqrt(2.0 - sqr(r))
    return vec(cos_p * scale, sin_p * scale, z)


def equal_area_sphere_to_square(d):
    """Inverse of :func:`equal_area_square_to_sphere`."""
    x = torch.abs(d[..., 0])
    y = torch.abs(d[..., 1])
    z = torch.abs(d[..., 2])
    r = safe_sqrt(1.0 - z)
    a = torch.maximum(x, y)
    b = torch.minimum(x, y)
    a_zero = a == 0.0
    b = torch.where(a_zero, 0.0, b / torch.where(a_zero, 1.0, a))
    phi = torch.atan(b) * (2.0 / math.pi)
    phi = torch.where(x < y, 1.0 - phi, phi)
    v = phi * r
    u = r - v
    # Southern hemisphere: fold.
    south = d[..., 2] < 0.0
    u, v = torch.where(south, 1.0 - v, u), torch.where(south, 1.0 - u, v)
    u = torch.copysign(u, d[..., 0])
    v = torch.copysign(v, d[..., 1])
    return vec2(0.5 * (u + 1.0), 0.5 * (v + 1.0))


def wrap_equal_area_square(uv):
    """Fold out-of-bounds equal-area square coordinates back in."""
    u, v = uv[..., 0], uv[..., 1]
    u_lt, u_gt = u < 0.0, u > 1.0
    v_lt, v_gt = v < 0.0, v > 1.0
    u2 = torch.where(u_lt, -u, torch.where(u_gt, 2.0 - u, u))
    v2 = torch.where(u_lt | u_gt, 1.0 - v, v)
    v3 = torch.where(v_lt, -v2, torch.where(v_gt, 2.0 - v2, v2))
    u3 = torch.where(v_lt | v_gt, 1.0 - u2, u2)
    return vec2(u3, v3)


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
