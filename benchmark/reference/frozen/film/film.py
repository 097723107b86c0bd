"""Spectral film and pixel sensor (port of ``shimmer_tpu/film/film.py``:
``PixelSensor`` with ``create``, ``RgbFilm`` with the per-sample film
scatter, the splats over a filter's footprint and the merge of two
states, ``FilmState``)."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from benchmark.reference.frozen.color.color import white_balance, xyz_to_xy
from benchmark.reference.frozen.config import resolve_device
from benchmark.reference.frozen.ops.math import safe_div
from benchmark.reference.frozen.spectra.sampled import SampledWavelengths
from benchmark.reference.frozen.spectra.spectrum import (
    Spectrum,
    cie_x_spectrum,
    cie_y_spectrum,
    cie_z_spectrum,
    d_illuminant,
    dense_sample,
    inner_product,
    spectrum_xyz,
    swatch_reflectances,
)


class PixelSensor:
    """Spectral sensor response and the sensor-RGB -> XYZ matrix.

    Without ``rgb_bar`` the response is the CIE XYZ matching functions,
    white-balanced from ``sensor_illum`` to the color space's white when
    one is given; with ``rgb_bar`` the matrix is the least-squares fit of
    the 24 ColorChecker swatches as seen by the sensor under
    ``sensor_illum`` against their XYZ under the color space's
    illuminant."""

    def __init__(self, colorspace, sensor_illum: Spectrum | None = None,
                 imaging_ratio: float = 1.0, rgb_bar=None):
        self.imaging_ratio = float(imaging_ratio)
        if rgb_bar is None:
            self.rgb_bar_dense = np.stack(
                [cie_x_spectrum().to_dense(), cie_y_spectrum().to_dense(),
                 cie_z_spectrum().to_dense()]
            )
            if sensor_illum is not None:
                src_white = xyz_to_xy(spectrum_xyz(sensor_illum))
                self.xyz_from_sensor_rgb = white_balance(src_white, colorspace.w)
            else:
                self.xyz_from_sensor_rgb = np.eye(3)
        else:
            if sensor_illum is None:
                raise ValueError("a sensor with its own RGB response needs an illuminant")
            r, g, b = rgb_bar
            self.rgb_bar_dense = np.stack([r.to_dense(), g.to_dense(), b.to_dense()])
            swatches = swatch_reflectances()
            rgb_camera = np.stack([_project_reflectance(s, sensor_illum, r, g, b)
                                   for s in swatches])
            sensor_white_g = inner_product(sensor_illum, g)
            sensor_white_y = inner_product(sensor_illum, cie_y_spectrum())
            xyz_output = np.stack([
                _project_reflectance(s, colorspace.illuminant, cie_x_spectrum(),
                                     cie_y_spectrum(), cie_z_spectrum())
                * (sensor_white_y / sensor_white_g)
                for s in swatches
            ])
            m, *_ = np.linalg.lstsq(rgb_camera, xyz_output, rcond=None)
            self.xyz_from_sensor_rgb = m.T
        self._bars = {}

    @staticmethod
    def create(colorspace, exposure_time: float = 1.0, iso: float = 100.0,
               white_balance_temp: float = 0.0, sensor_name: str = "cie1931") -> "PixelSensor":
        """The scene file's sensor: imaging ratio exposure * ISO / 100, a D
        illuminant white balance at ``white_balance_temp`` (0: none); only
        the CIE 1931 sensor is known, another name raises ValueError."""
        if sensor_name != "cie1931" and white_balance_temp == 0.0:
            white_balance_temp = 6500.0
        imaging_ratio = exposure_time * iso / 100.0
        sensor_illum = d_illuminant(white_balance_temp) if white_balance_temp != 0.0 else None
        if sensor_name == "cie1931":
            return PixelSensor(colorspace, sensor_illum, imaging_ratio)
        raise ValueError(f"unknown sensor: {sensor_name}")

    def _bars_on(self, device):
        key = str(device)
        if key not in self._bars:
            self._bars[key] = torch.as_tensor(self.rgb_bar_dense, dtype=torch.float32,
                                              device=device)
        return self._bars[key]

    def to_sensor_rgb(self, L, swl: SampledWavelengths):
        """(..., 4) radiance + wavelengths -> (..., 3) sensor RGB."""
        bars = self._bars_on(L.device)
        l = safe_div(L, swl.pdf)
        r = torch.mean(dense_sample(bars[0], swl.lam) * l, dim=-1)
        g = torch.mean(dense_sample(bars[1], swl.lam) * l, dim=-1)
        b = torch.mean(dense_sample(bars[2], swl.lam) * l, dim=-1)
        return torch.stack([r, g, b], dim=-1) * self.imaging_ratio


def _project_reflectance(refl, illum, b1, b2, b3):
    """<b_i refl illum> / <b2 illum> over 1 nm bins."""
    lam = np.arange(360.0, 831.0)
    il = illum.get(lam)
    g_int = np.sum(b2.get(lam) * il)
    return np.array([
        np.sum(b1.get(lam) * refl.get(lam) * il),
        np.sum(b2.get(lam) * refl.get(lam) * il),
        np.sum(b3.get(lam) * refl.get(lam) * il),
    ]) / g_int


def add_at_pixels(acc: torch.Tensor, pixel_xy, values) -> torch.Tensor:
    """``acc`` (H, W, ...) with ``values`` (N, ...) added at the (x, y)
    pixels ``pixel_xy`` (N, 2), H and W read from ``acc``.  A lane whose
    pixel lies outside the H x W grid is dropped: it adds to a spare slot
    past the grid that is cut off again."""
    h, w = acc.shape[:2]
    px = pixel_xy[..., 0].reshape(-1).long()
    py = pixel_xy[..., 1].reshape(-1).long()
    inside = (px >= 0) & (px < w) & (py >= 0) & (py < h)
    flat = torch.where(inside, py * w + px, h * w)
    tail = acc.shape[2:]
    spare = torch.cat([acc.reshape((h * w,) + tail),
                       torch.zeros((1,) + tail, dtype=acc.dtype, device=acc.device)])
    out = spare.index_put((flat,), values.reshape((-1,) + tail).to(acc.dtype), accumulate=True)
    return out[: h * w].reshape(acc.shape)


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

    def add_samples(self, state: FilmState, pixel_xy, L, swl, weight) -> FilmState:
        """Accumulate one filter-weighted sample per lane.  The lanes must
        name distinct pixels of ``state``, whose rows may be a band of the
        image (``parallel.render.LocalBandFilm``); a lane whose pixel lies
        outside them (a padded lane is sent to (width, height)) is
        dropped."""
        rgb = self._clamped_rgb(L, swl) * weight[..., None]
        return FilmState(rgb_sum=add_at_pixels(state.rgb_sum, pixel_xy, rgb),
                         weight_sum=add_at_pixels(state.weight_sum, pixel_xy, weight),
                         rgb_splat=state.rgb_splat)

    def add_splats(self, state: FilmState, p_film, L, swl) -> FilmState:
        """Splat radiance over the filter's footprint: each sample at
        continuous film position ``p_film`` (..., 2) adds ``rgb * f(offset)``
        to every pixel of its static (2r+1)^2 window that lies on the film
        and has a positive filter weight.

        Many samples land on one pixel, and an accumulating scatter on the
        card adds repeated indices in an order that changes from run to
        run.  So the contributions are summed per pixel in a fixed order
        first: laid out window offset by window offset (dy, then dx, as
        the reference's loop adds them) and sample by sample within one,
        stably sorted by pixel, then summed within each pixel's run by a
        segmented doubling scan (step s adds the partial sum s places
        back when it lies in the same run).  One add per distinct pixel
        follows, as in ``add_samples``.  The same inputs give the same
        bits on every run."""
        w, h = self.resolution
        rgb = self._clamped_rgb(L, swl).reshape(-1, 3)
        p = p_film.reshape(-1, 2)
        rx, ry = self.filter.radius
        p_discrete = p - 0.5
        x0 = torch.ceil(p_discrete[:, 0] - rx).to(torch.int64)
        y0 = torch.ceil(p_discrete[:, 1] - ry).to(torch.int64)
        nx = int(np.floor(2 * rx)) + 1
        ny = int(np.floor(2 * ry)) + 1
        keys, vals = [], []
        for dy in range(ny):
            for dx in range(nx):
                px = x0 + dx
                py = y0 + dy
                offset = torch.stack([px.to(torch.float32) + 0.5 - p[:, 0],
                                      py.to(torch.float32) + 0.5 - p[:, 1]], dim=-1)
                fw = self.filter.evaluate(offset)
                valid = (px >= 0) & (px < w) & (py >= 0) & (py < h) & (fw > 0)
                keys.append(torch.where(valid, py * w + px, h * w))
                vals.append(torch.where(valid[:, None], rgb * fw[:, None], 0.0))
        key, order = torch.sort(torch.cat(keys), stable=True)
        val = torch.cat(vals)[order]
        pix, runs = torch.unique_consecutive(key, return_counts=True)
        s, longest = 1, int(runs.max()) if runs.numel() else 0
        while s < longest:
            same = (key[s:] == key[:-s])[:, None]
            val = torch.cat([val[:s], val[s:] + torch.where(same, val[:-s], 0.0)])
            s *= 2
        sums = val[torch.cumsum(runs, 0) - 1]
        keep = pix < h * w  # the spare key h * w holds the dropped entries
        flat = state.rgb_splat.reshape(h * w, 3).index_put(
            (pix[keep],), sums[keep].to(state.rgb_splat.dtype), accumulate=True)
        return FilmState(rgb_sum=state.rgb_sum, weight_sum=state.weight_sum,
                         rgb_splat=flat.reshape(h, w, 3))

    def merge(self, a: FilmState, b: FilmState) -> FilmState:
        """Combine the accumulators of two waves or shards."""
        return FilmState(rgb_sum=a.rgb_sum + b.rgb_sum, weight_sum=a.weight_sum + b.weight_sum,
                         rgb_splat=a.rgb_splat + b.rgb_splat)

    def get_image(self, state: FilmState, splat_scale: float = 1.0):
        """Resolve the accumulators to (H, W, 3) output-colorspace RGB."""
        rgb = safe_div(state.rgb_sum, state.weight_sum[..., None])
        rgb = rgb + splat_scale * state.rgb_splat / self.filter_integral
        m = torch.as_tensor(
            np.asarray(self.output_rgb_from_sensor_rgb, np.float32), device=rgb.device
        )
        return torch.einsum("ij,hwj->hwi", m, rgb)
