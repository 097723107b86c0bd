"""RGB color spaces (port of ``shimmer_tpu/color/colorspace.py``).

The slice renders in sRGB; the other named spaces wait for the loader.
"""

from __future__ import annotations

import functools

import numpy as np

from shimmer_tpu_torch.color.color import xyz_from_xy_y, xyz_to_xy
from shimmer_tpu_torch.spectra.spectrum import Spectrum, named_spectrum, spectrum_xyz


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

    def __repr__(self):
        return f"RgbColorSpace({self.name})"


@functools.cache
def get_named_color_space(name: str) -> RgbColorSpace:
    name = name.lower().replace("_", "-")
    if name == "srgb":
        return RgbColorSpace(
            (0.64, 0.33), (0.3, 0.6), (0.15, 0.06),
            named_spectrum("stdillum-D65"), "sRGB",
        )
    raise NotImplementedError(f"color space {name!r} is not ported yet")
