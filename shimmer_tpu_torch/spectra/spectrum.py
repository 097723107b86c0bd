"""Spectral distributions (port of ``shimmer_tpu/spectra/spectrum.py``).

Host classes (numpy) build scene spectra and bake them to 471-entry dense
tables (1 nm bins over [360, 830]); device code samples the tables at the
hero wavelengths.  The data tables are read from the reference package's
``spectra/data/spectra_data.npz``; nothing is copied.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch

import shimmer_tpu
from shimmer_tpu_torch.spectra.sampled import LAMBDA_MAX, LAMBDA_MIN

CIE_Y_INTEGRAL = 106.856895
N_DENSE = 471

_DATA_PATH = Path(shimmer_tpu.__file__).parent / "spectra" / "data" / "spectra_data.npz"


@functools.cache
def _data():
    return np.load(_DATA_PATH)


@functools.cache
def cie_xyz_dense() -> np.ndarray:
    """(3, 471) CIE 1931 matching functions at 1 nm from 360 nm."""
    d = _data()
    return np.stack([d["cie_x"], d["cie_y"], d["cie_z"]], axis=0).astype(np.float32)


def _dense_index(lam):
    """Truncating wavelength -> bin index, and the in-range mask."""
    idx = lam.to(torch.int32) - int(LAMBDA_MIN)
    in_range = (idx >= 0) & (idx < N_DENSE)
    return torch.clamp(idx, 0, N_DENSE - 1).long(), in_range


def dense_sample(values, lam):
    """Evaluate a (471,) dense table at (..., 4) wavelengths; 0 outside."""
    idx, in_range = _dense_index(lam)
    return torch.where(in_range, values[idx], 0.0)


def dense_sample_rows(table, row_idx, lam):
    """``dense_sample(table[row_idx], lam)`` as one 2-D gather."""
    idx, in_range = _dense_index(lam)
    return torch.where(in_range, table[row_idx.long()[..., None], idx], 0.0)


# --- host-side spectrum classes ---


class Spectrum:
    def get(self, lam):
        raise NotImplementedError

    def to_dense(self) -> np.ndarray:
        """Bake to a (471,) table at 1 nm bins."""
        lam = np.arange(LAMBDA_MIN, LAMBDA_MAX + 1.0)
        return np.asarray(self.get(lam), np.float32)


class ConstantSpectrum(Spectrum):
    def __init__(self, c: float):
        self.c = float(c)

    def get(self, lam):
        return np.full_like(np.asarray(lam, np.float64), self.c)


class DenselySampledSpectrum(Spectrum):
    def __init__(self, values, lambda_min=int(LAMBDA_MIN)):
        self.values = np.asarray(values, np.float64)
        self.lambda_min = int(lambda_min)

    def get(self, lam):
        idx = np.asarray(lam, np.int64) - self.lambda_min
        ok = (idx >= 0) & (idx < len(self.values))
        return np.where(ok, self.values[np.clip(idx, 0, len(self.values) - 1)], 0.0)


class PiecewiseLinearSpectrum(Spectrum):
    """Sorted (lambda, value) knots, linearly interpolated, 0 outside."""

    def __init__(self, lambdas, values):
        self.lambdas = np.asarray(lambdas, np.float64)
        self.values = np.asarray(values, np.float64)
        if not np.all(np.diff(self.lambdas) > 0):
            raise ValueError("PiecewiseLinearSpectrum needs increasing wavelengths")

    @staticmethod
    def from_interleaved(samples, normalize: bool):
        samples = np.asarray(samples, np.float64)
        lam = samples[0::2]
        val = samples[1::2]
        if lam[0] > LAMBDA_MIN:
            lam = np.concatenate([[LAMBDA_MIN - 1.0], lam])
            val = np.concatenate([[val[0]], val])
        if lam[-1] < LAMBDA_MAX:
            lam = np.concatenate([lam, [LAMBDA_MAX + 1.0]])
            val = np.concatenate([val, [val[-1]]])
        s = PiecewiseLinearSpectrum(lam, val)
        if normalize:
            s = PiecewiseLinearSpectrum(
                s.lambdas,
                s.values * (CIE_Y_INTEGRAL / inner_product(s, cie_y_spectrum())),
            )
        return s

    def get(self, lam):
        lam = np.asarray(lam, np.float64)
        v = np.interp(lam, self.lambdas, self.values)
        inside = (lam >= self.lambdas[0]) & (lam <= self.lambdas[-1])
        return np.where(inside, v, 0.0)


@functools.cache
def cie_x_spectrum() -> DenselySampledSpectrum:
    return DenselySampledSpectrum(_data()["cie_x"])


@functools.cache
def cie_y_spectrum() -> DenselySampledSpectrum:
    return DenselySampledSpectrum(_data()["cie_y"])


@functools.cache
def cie_z_spectrum() -> DenselySampledSpectrum:
    return DenselySampledSpectrum(_data()["cie_z"])


_NAMED_SPECS = {
    "stdillum-D65": ("cie_illum_d6500", True),
}


@functools.cache
def named_spectrum(name: str) -> PiecewiseLinearSpectrum:
    """Named spectra the slice uses (the sRGB illuminant)."""
    if name not in _NAMED_SPECS:
        raise NotImplementedError(f"named spectrum {name!r} is not ported yet")
    key, normalize = _NAMED_SPECS[name]
    return PiecewiseLinearSpectrum.from_interleaved(_data()[key], normalize)


def inner_product(a: Spectrum, b: Spectrum) -> float:
    """Sum over 1 nm bins of a(lambda) * b(lambda)."""
    lam = np.arange(LAMBDA_MIN, LAMBDA_MAX + 1.0)
    return float(np.sum(a.get(lam) * b.get(lam)))


def spectrum_to_photometric(s: Spectrum) -> float:
    """Luminous normalization sum Y(lambda) s(lambda) (an RGB illuminant
    spectrum is measured by its base illuminant)."""
    base = getattr(s, "photometric_base", None)
    target = base() if base is not None else s
    return inner_product(cie_y_spectrum(), target)


def spectrum_xyz(s: Spectrum) -> np.ndarray:
    return np.array(
        [
            inner_product(cie_x_spectrum(), s),
            inner_product(cie_y_spectrum(), s),
            inner_product(cie_z_spectrum(), s),
        ]
    ) / CIE_Y_INTEGRAL
