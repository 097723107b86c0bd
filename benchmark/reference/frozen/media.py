"""Homogeneous participating media (port of ``shimmer_tpu/media.py``).

A medium is a row of dense (471-bin) absorption and scattering spectra and
a Henyey-Greenstein asymmetry ``g``.  A path lane carries the id of the
medium it is in (-1: vacuum); ``integrators/path.py`` samples a free-flight
distance over each traced segment with closed-form transmittance
(channel-0 distance sampling at the hero wavelength, the spectral ratio on
the others), and the wavefront scatters, lights and crosses declared
``MediumInterface`` boundaries with it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference.frozen.config import f32
from benchmark.reference.frozen.spectra.rgb2spec import fit_rgb_coeffs, sigmoid_poly_sample
from benchmark.reference.frozen.spectra.spectrum import Spectrum, dense_sample_rows


@dataclasses.dataclass(frozen=True)
class MediumData:
    sigma_a: torch.Tensor  # (M, 471) dense absorption spectra (scale applied)
    sigma_s: torch.Tensor  # (M, 471) dense scattering spectra (scale applied)
    g: torch.Tensor        # (M,) HG asymmetry


def _to_dense(v, colorspace) -> np.ndarray:
    """Spectrum | rgb triple | scalar -> (471,) float64 samples.  An rgb
    triple takes the unbounded uplift: rgb / (2 max) fit as an albedo
    polynomial, evaluated in float32 on the CPU as the reference does, and
    scaled by 2 max."""
    if isinstance(v, Spectrum):
        return np.asarray(v.to_dense(), np.float64)
    arr = np.asarray(v, np.float64).reshape(-1)
    if arr.size == 1:
        return np.full(471, float(arr[0]))
    if arr.size != 3:
        raise ValueError(f"sigma must be a scalar, an rgb triple or a Spectrum: {v!r}")
    m = float(arr.max())
    if m <= 0.0:
        return np.zeros(471)
    coeffs = fit_rgb_coeffs((arr / (2.0 * m))[None], colorspace)[0]
    lam = torch.arange(360.0, 831.0, dtype=torch.float32)
    return 2.0 * m * sigmoid_poly_sample(torch.from_numpy(coeffs), lam).numpy()


def make_media_table(media: list[dict], colorspace, device=None) -> MediumData:
    """Host bake of medium dicts into device tables.  Each dict:
    ``sigma_a`` / ``sigma_s`` (a Spectrum, an rgb triple or a scalar;
    default 1), ``scale`` (multiplies both) and ``g`` (default 0)."""
    m = len(media)
    sa = np.zeros((m, 471), np.float32)
    ss = np.zeros((m, 471), np.float32)
    g = np.zeros(m, np.float32)
    for i, md in enumerate(media):
        scale = float(md.get("scale", 1.0))
        sa[i] = scale * _to_dense(md.get("sigma_a", 1.0), colorspace)
        ss[i] = scale * _to_dense(md.get("sigma_s", 1.0), colorspace)
        g[i] = float(md.get("g", 0.0))
    return MediumData(sigma_a=f32(sa, device), sigma_s=f32(ss, device), g=f32(g, device))


def medium_sigma(media: MediumData, mid, lam):
    """sigma_a, sigma_s (..., 4) at the hero wavelengths and g (...,) for
    per-lane medium ids; an id < 0 is vacuum (zero sigmas; g read from
    row 0 and never used)."""
    midc = torch.clamp(mid.long(), 0, media.g.shape[0] - 1)
    on = (mid >= 0)[..., None]
    sa = dense_sample_rows(media.sigma_a, midc, lam)
    ss = dense_sample_rows(media.sigma_s, midc, lam)
    return torch.where(on, sa, 0.0), torch.where(on, ss, 0.0), media.g[midc]
