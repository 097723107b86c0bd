"""RGB color spaces (port of ``shimmer_tpu/color/colorspace.py``): sRGB,
Rec2020, ACES2065-1 and DCI-P3, their XYZ <-> RGB matrices derived from
the primaries and the illuminant's white point as the reference does."""

from __future__ import annotations

import functools

import numpy as np

from benchmark.reference.frozen.color.color import xyz_from_xy_y, xyz_to_xy
from benchmark.reference.frozen.spectra.spectrum import (
    Spectrum,
    d_illuminant,
    named_spectrum,
    spectrum_xyz,
)


class RgbColorSpace:
    def __init__(self, r_xy, g_xy, b_xy, illuminant: Spectrum, name: str = ""):
        self.name = name
        self.r = np.asarray(r_xy, np.float64)
        self.g = np.asarray(g_xy, np.float64)
        self.b = np.asarray(b_xy, np.float64)
        self.illuminant = illuminant
        w_xyz = spectrum_xyz(illuminant)
        self.w = xyz_to_xy(w_xyz)
        rgb = np.stack(
            [xyz_from_xy_y(self.r), xyz_from_xy_y(self.g), xyz_from_xy_y(self.b)],
            axis=-1,
        )
        c = np.linalg.solve(rgb, w_xyz)
        self.xyz_from_rgb = rgb @ np.diag(c)
        self.rgb_from_xyz = np.linalg.inv(self.xyz_from_rgb)

    def to_rgb(self, xyz):
        return self.rgb_from_xyz @ np.asarray(xyz)

    def to_xyz(self, rgb):
        return self.xyz_from_rgb @ np.asarray(rgb)

    def __repr__(self):
        return f"RgbColorSpace({self.name})"


@functools.cache
def get_named_color_space(name: str) -> RgbColorSpace:
    """A named color space; an unknown name raises ValueError."""
    name = name.lower().replace("_", "-")
    if name == "srgb":
        return RgbColorSpace(
            (0.64, 0.33), (0.3, 0.6), (0.15, 0.06),
            named_spectrum("stdillum-D65"), "sRGB",
        )
    if name == "rec2020":
        return RgbColorSpace(
            (0.708, 0.292), (0.170, 0.797), (0.131, 0.046),
            named_spectrum("stdillum-D65"), "Rec2020",
        )
    if name in ("aces2065-1", "aces"):
        return RgbColorSpace(
            (0.7347, 0.2653), (0.0, 1.0), (0.0001, -0.077),
            named_spectrum("illum-acesD60"), "ACES2065-1",
        )
    if name == "dci-p3":
        return RgbColorSpace(
            (0.68, 0.32), (0.265, 0.690), (0.15, 0.06),
            d_illuminant(6300.0), "DCI-P3",
        )
    raise ValueError(f"unknown color space: {name}")
