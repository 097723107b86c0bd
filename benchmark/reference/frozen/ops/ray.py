"""Rays and ray differentials (port of ``shimmer_tpu/ops/ray.py``: the
pieces the forward render path and the cameras use)."""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference.frozen.ops.vecmath import face_forward


@dataclasses.dataclass(frozen=True)
class Ray:
    o: torch.Tensor  # (..., 3)
    d: torch.Tensor  # (..., 3)


@dataclasses.dataclass(frozen=True)
class RayDifferential:
    """A main ray with the rays one pixel over in x and in y."""

    ray: Ray
    rx_o: torch.Tensor
    rx_d: torch.Tensor
    ry_o: torch.Tensor
    ry_d: torch.Tensor
    has_differentials: torch.Tensor  # (...,) bool

    @staticmethod
    def from_ray(ray: Ray) -> "RayDifferential":
        z = torch.zeros_like(ray.o)
        return RayDifferential(
            ray=ray, rx_o=z, rx_d=z, ry_o=z, ry_d=z,
            has_differentials=torch.zeros(ray.o.shape[:-1], dtype=torch.bool,
                                          device=ray.o.device),
        )

    def scale_differentials(self, s):
        """The offset rays moved toward the main ray by the factor s."""
        o, d = self.ray.o, self.ray.d
        s = torch.as_tensor(s, dtype=torch.float32, device=o.device)[..., None]
        return RayDifferential(
            ray=self.ray,
            rx_o=o + (self.rx_o - o) * s,
            rx_d=d + (self.rx_d - d) * s,
            ry_o=o + (self.ry_o - o) * s,
            ry_d=d + (self.ry_d - d) * s,
            has_differentials=self.has_differentials,
        )


def offset_ray_origin(p, n, w):
    """Offset a spawned ray origin off the surface by a relative epsilon
    scaled by |p|, along the normal flipped toward w."""
    d = torch.sum(torch.abs(p), dim=-1) * 1e-5 + 1e-6
    return p + face_forward(n, w) * d[..., None]
