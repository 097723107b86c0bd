"""Pixel reconstruction filters (port of ``shimmer_tpu/film/filters.py``).

A filter is a host object with static parameters; ``evaluate`` and
``sample`` run on the device of their input.  The box and triangle
filters sample analytically; the Gaussian, Mitchell and Lanczos-sinc
filters sample a 64 x 64 table of |f| (pbrt's FilterSampler) with weight
f / pdf.  The table is evaluated on the host in float32 on the
reference's grid and its CDFs are built by ``xla_cumsum``, so a table
built from the same values is byte-equal to the reference's; a copy goes
to each device that samples it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference.frozen.ops.math import sqr, windowed_sinc
from benchmark.reference.frozen.ops.sampling import build_piecewise_constant_2d, sample_tent
from benchmark.reference.frozen.ops.vecmath import vec2


class Filter:
    """Filter interface: ``radius`` (rx, ry), ``evaluate(p)``,
    ``integral()`` and ``sample(u) -> (offset, weight)``."""

    radius: tuple

    def evaluate(self, p):
        raise NotImplementedError

    def integral(self) -> float:
        raise NotImplementedError

    def sample(self, u):
        raise NotImplementedError

    @staticmethod
    def create(name: str, **params) -> "Filter":
        """A filter by its scene-file name."""
        name = name.lower()
        if name == "box":
            return BoxFilter(params.get("xradius", 0.5), params.get("yradius", 0.5))
        if name == "triangle":
            return TriangleFilter(params.get("xradius", 2.0), params.get("yradius", 2.0))
        if name == "gaussian":
            return GaussianFilter(params.get("xradius", 1.5), params.get("yradius", 1.5),
                                  params.get("sigma", 0.5))
        if name == "mitchell":
            return MitchellFilter(params.get("xradius", 2.0), params.get("yradius", 2.0),
                                  params.get("B", 1.0 / 3.0), params.get("C", 1.0 / 3.0))
        if name in ("sinc", "lanczossinc"):
            return LanczosSincFilter(params.get("xradius", 4.0), params.get("yradius", 4.0),
                                     params.get("tau", 3.0))
        raise ValueError(f"unknown filter: {name}")


class BoxFilter(Filter):
    """Box filter, radius 0.5 by default."""

    def __init__(self, xr=0.5, yr=0.5):
        self.radius = (float(xr), float(yr))

    def evaluate(self, p):
        rx, ry = self.radius
        inside = (torch.abs(p[..., 0]) <= rx) & (torch.abs(p[..., 1]) <= ry)
        return torch.where(inside, 1.0, 0.0)

    def integral(self):
        return 2.0 * self.radius[0] * 2.0 * self.radius[1]

    def sample(self, u):
        rx, ry = self.radius
        p = vec2((2.0 * u[..., 0] - 1.0) * rx, (2.0 * u[..., 1] - 1.0) * ry)
        return p, torch.ones(u.shape[:-1], dtype=torch.float32, device=u.device)


class TriangleFilter(Filter):
    def __init__(self, xr=2.0, yr=2.0):
        self.radius = (float(xr), float(yr))

    def evaluate(self, p):
        rx, ry = self.radius
        return (torch.clamp(rx - torch.abs(p[..., 0]), min=0.0)
                * torch.clamp(ry - torch.abs(p[..., 1]), min=0.0))

    def integral(self):
        return sqr(self.radius[0]) * sqr(self.radius[1])

    def sample(self, u):
        p = vec2(sample_tent(u[..., 0], self.radius[0]), sample_tent(u[..., 1], self.radius[1]))
        return p, torch.ones(u.shape[:-1], dtype=torch.float32, device=u.device)


class _SampledFilter(Filter):
    """Tabulated |f| sampling for the filters without an analytic
    inverse."""

    _TABLE = 64

    def _build_sampler(self):
        n = self._TABLE
        rx, ry = self.radius
        xs = (np.arange(n) + 0.5) / n * 2.0 * rx - rx
        ys = (np.arange(n) + 0.5) / n * 2.0 * ry - ry
        px, py = np.meshgrid(xs, ys)
        pts = torch.as_tensor(np.stack([px, py], axis=-1), dtype=torch.float32)
        self._f_table = self.evaluate(pts)
        self._dist = build_piecewise_constant_2d(
            torch.abs(self._f_table), domain=((-rx, -ry), (rx, ry)), device="cpu"
        )
        self._dists = {"cpu": self._dist}

    def _dist_on(self, device):
        key = str(device)
        if key not in self._dists:
            d = self._dist
            self._dists[key] = dataclasses.replace(d, **{
                f.name: getattr(d, f.name).to(device) for f in dataclasses.fields(d)
                if isinstance(getattr(d, f.name), torch.Tensor)
            })
        return self._dists[key]

    def sample(self, u):
        p, pdf = self._dist_on(u.device).sample(u)
        f = self.evaluate(p)
        w = torch.where(pdf > 0.0, f / torch.where(pdf > 0.0, pdf, 1.0), 0.0)
        return p, w


class GaussianFilter(_SampledFilter):
    def __init__(self, xr=1.5, yr=1.5, sigma=0.5, ):
        self.radius = (float(xr), float(yr))
        self.sigma = float(sigma)
        self._exp_x = float(np.exp(-sqr(xr) / (2.0 * sigma * sigma)))
        self._exp_y = float(np.exp(-sqr(yr) / (2.0 * sigma * sigma)))
        self._build_sampler()

    def _g(self, x, exp_r):
        g = torch.exp(-sqr(x) / (2.0 * self.sigma**2))
        return torch.clamp(g - exp_r, min=0.0)

    def evaluate(self, p):
        return self._g(p[..., 0], self._exp_x) * self._g(p[..., 1], self._exp_y)

    def integral(self):
        # The integral of max(0, g(x) - g(r)) over [-r, r], separable.
        from scipy.special import erf

        s = self.sigma
        rx, ry = self.radius

        def one(r, e):
            return s * np.sqrt(2 * np.pi) * erf(r / (s * np.sqrt(2))) - 2 * r * e

        return float(one(rx, self._exp_x) * one(ry, self._exp_y))


class MitchellFilter(_SampledFilter):
    def __init__(self, xr=2.0, yr=2.0, b=1.0 / 3.0, c=1.0 / 3.0, ):
        self.radius = (float(xr), float(yr))
        self.b, self.c = float(b), float(c)
        self._build_sampler()

    def _mitchell_1d(self, x):
        b, c = self.b, self.c
        x = torch.abs(2.0 * x)
        x2, x3 = x * x, x * x * x
        inner = ((12 - 9 * b - 6 * c) * x3 + (-18 + 12 * b + 6 * c) * x2
                 + (6 - 2 * b)) * (1.0 / 6.0)
        outer = ((-b - 6 * c) * x3 + (6 * b + 30 * c) * x2 + (-12 * b - 48 * c) * x
                 + (8 * b + 24 * c)) * (1.0 / 6.0)
        return torch.where(x < 1.0, inner, torch.where(x < 2.0, outer, 0.0))

    def evaluate(self, p):
        rx, ry = self.radius
        return self._mitchell_1d(p[..., 0] / rx) * self._mitchell_1d(p[..., 1] / ry)

    def integral(self):
        return self.radius[0] * self.radius[1] / 4.0


class LanczosSincFilter(_SampledFilter):
    def __init__(self, xr=4.0, yr=4.0, tau=3.0, ):
        self.radius = (float(xr), float(yr))
        self.tau = float(tau)
        self._build_sampler()

    def evaluate(self, p):
        return (windowed_sinc(p[..., 0], self.radius[0], self.tau)
                * windowed_sinc(p[..., 1], self.radius[1], self.tau))

    def integral(self):
        # Trapezoidal quadrature over a 513 x 513 grid, as the reference.
        n = 513
        rx, ry = self.radius
        xs = np.linspace(-rx, rx, n)
        ys = np.linspace(-ry, ry, n)
        px, py = np.meshgrid(xs, ys)
        f = self.evaluate(torch.as_tensor(np.stack([px, py], -1), dtype=torch.float32)).numpy()
        trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy < 2 has trapz only
        return float(trapezoid(trapezoid(f, ys, axis=0), xs))


def get_camera_sample(filter_, pixel_xy, u_filter, u_lens):
    """Pixel coordinate + uniform draws -> (p_film, filter weight, u_lens),
    with filter importance sampling and the half-pixel offset."""
    offset, weight = filter_.sample(u_filter)
    p_film = pixel_xy.to(torch.float32) + 0.5 + offset
    return p_film, weight, u_lens
