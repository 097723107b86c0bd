"""Spectral film and pixel sensor (port of ``shimmer_tpu/film/film.py``:
``PixelSensor`` with the CIE 1931 response and no white balance, which is
what the slice's scenes use; ``RgbFilm``; ``FilmState``)."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from shimmer_tpu_torch.config import resolve_device
from shimmer_tpu_torch.ops.math import safe_div
from shimmer_tpu_torch.spectra.sampled import SampledWavelengths
from shimmer_tpu_torch.spectra.spectrum import (
    cie_x_spectrum,
    cie_y_spectrum,
    cie_z_spectrum,
    dense_sample,
)


class PixelSensor:
    """Spectral sensor response: the CIE XYZ matching functions, so sensor
    RGB is XYZ (imaging ratio 1)."""

    def __init__(self, colorspace):
        self.rgb_bar_dense = np.stack(
            [
                cie_x_spectrum().to_dense(),
                cie_y_spectrum().to_dense(),
                cie_z_spectrum().to_dense(),
            ]
        )
        self.xyz_from_sensor_rgb = np.eye(3)
        self._bars = {}

    def _bars_on(self, device):
        key = str(device)
        if key not in self._bars:
            self._bars[key] = torch.as_tensor(
                self.rgb_bar_dense, dtype=torch.float32, device=device
            )
        return self._bars[key]

    def to_sensor_rgb(self, L, swl: SampledWavelengths):
        """(..., 4) radiance + wavelengths -> (..., 3) sensor RGB."""
        bars = self._bars_on(L.device)
        l = safe_div(L, swl.pdf)
        r = torch.mean(dense_sample(bars[0], swl.lam) * l, dim=-1)
        g = torch.mean(dense_sample(bars[1], swl.lam) * l, dim=-1)
        b = torch.mean(dense_sample(bars[2], swl.lam) * l, dim=-1)
        return torch.stack([r, g, b], dim=-1)


@dataclasses.dataclass(frozen=True)
class FilmState:
    """Per-pixel accumulators, (H, W, ...) tensors."""

    rgb_sum: torch.Tensor     # (H, W, 3)
    weight_sum: torch.Tensor  # (H, W)
    rgb_splat: torch.Tensor   # (H, W, 3)


class RgbFilm:
    def __init__(self, resolution, filter_, sensor: PixelSensor, colorspace,
                 max_component_value: float = float("inf")):
        self.resolution = tuple(resolution)  # (width, height)
        self.filter = filter_
        self.sensor = sensor
        self.colorspace = colorspace
        self.max_component_value = float(max_component_value)
        self.filter_integral = float(filter_.integral())
        self.output_rgb_from_sensor_rgb = colorspace.rgb_from_xyz @ sensor.xyz_from_sensor_rgb

    def init_state(self, device=None) -> FilmState:
        """Zeroed accumulators on ``device`` (default: the CUDA card)."""
        device = resolve_device(device)
        w, h = self.resolution
        return FilmState(
            rgb_sum=torch.zeros((h, w, 3), dtype=torch.float32, device=device),
            weight_sum=torch.zeros((h, w), dtype=torch.float32, device=device),
            rgb_splat=torch.zeros((h, w, 3), dtype=torch.float32, device=device),
        )

    def sample_wavelengths(self, u) -> SampledWavelengths:
        return SampledWavelengths.sample_visible(u)

    def _clamped_rgb(self, L, swl):
        rgb = self.sensor.to_sensor_rgb(L, swl)
        if math.isinf(self.max_component_value):
            return rgb
        m = torch.max(rgb, dim=-1).values
        scale = torch.where(
            m > self.max_component_value,
            self.max_component_value / torch.where(m > 0.0, m, torch.ones_like(m)),
            1.0,
        )
        return rgb * scale[..., None]

    def get_image(self, state: FilmState, splat_scale: float = 1.0):
        """Resolve the accumulators to (H, W, 3) output-colorspace RGB."""
        rgb = safe_div(state.rgb_sum, state.weight_sum[..., None])
        rgb = rgb + splat_scale * state.rgb_splat / self.filter_integral
        m = torch.as_tensor(
            np.asarray(self.output_rgb_from_sensor_rgb, np.float32), device=rgb.device
        )
        return torch.einsum("ij,hwj->hwi", m, rgb)
