"""Rays (port of ``shimmer_tpu/ops/ray.py``: the pieces the forward
render path uses)."""

from __future__ import annotations

import dataclasses

import torch

from shimmer_tpu_torch.ops.vecmath import face_forward


@dataclasses.dataclass(frozen=True)
class Ray:
    o: torch.Tensor  # (..., 3)
    d: torch.Tensor  # (..., 3)


def offset_ray_origin(p, n, w):
    """Offset a spawned ray origin off the surface by a relative epsilon
    scaled by |p|, along the normal flipped toward w."""
    d = torch.sum(torch.abs(p), dim=-1) * 1e-5 + 1e-6
    return p + face_forward(n, w) * d[..., None]
