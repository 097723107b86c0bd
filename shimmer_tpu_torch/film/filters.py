"""Pixel reconstruction filters (port of ``shimmer_tpu/film/filters.py``:
the box filter and ``get_camera_sample``)."""

from __future__ import annotations

import torch

from shimmer_tpu_torch.ops.vecmath import vec2


class BoxFilter:
    """Box filter, radius 0.5 by default."""

    def __init__(self, xr=0.5, yr=0.5):
        self.radius = (float(xr), float(yr))

    def integral(self):
        return 2.0 * self.radius[0] * 2.0 * self.radius[1]

    def sample(self, u):
        rx, ry = self.radius
        p = vec2((2.0 * u[..., 0] - 1.0) * rx, (2.0 * u[..., 1] - 1.0) * ry)
        return p, torch.ones(u.shape[:-1], dtype=torch.float32, device=u.device)


def get_camera_sample(filter_, pixel_xy, u_filter, u_lens):
    """Pixel coordinate + uniform draws -> (p_film, filter weight, u_lens),
    with filter importance sampling and the half-pixel offset."""
    offset, weight = filter_.sample(u_filter)
    p_film = pixel_xy.to(torch.float32) + 0.5 + offset
    return p_film, weight, u_lens
