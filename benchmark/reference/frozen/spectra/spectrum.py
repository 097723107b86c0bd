"""Spectral distributions (port of ``shimmer_tpu/spectra/spectrum.py``).

Host classes (numpy) build scene spectra and bake them to 471-entry dense
tables (1 nm bins over [360, 830]); device code samples the tables at the
hero wavelengths.  The data tables are read from the port's own copy of
the reference's ``spectra/data/spectra_data.npz``.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch

from benchmark.reference.frozen.spectra.sampled import LAMBDA_MAX, LAMBDA_MIN

CIE_Y_INTEGRAL = 106.856895
N_DENSE = 471

_DATA_PATH = Path(__file__).resolve().parent / "data" / "spectra_data.npz"


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


def cie_xyz_sample(lam):
    """The CIE X, Y and Z matching functions at (..., 4) wavelengths."""
    t = torch.as_tensor(cie_xyz_dense(), device=lam.device)
    return dense_sample(t[0], lam), dense_sample(t[1], lam), dense_sample(t[2], lam)


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


class BlackbodySpectrum(Spectrum):
    """Planck spectrum normalized to a peak of 1."""

    def __init__(self, t: float):
        self.t = float(t)
        lambda_max_m = 2.8977721e-3 / self.t  # Wien
        self.normalization = 1.0 / _planck(lambda_max_m * 1e9, self.t)

    def get(self, lam):
        return _planck(np.asarray(lam, np.float64), self.t) * self.normalization


def _planck(lam_nm, t):
    """Blackbody emitted radiance at lambda (nm), temperature t (K)."""
    if t < 0.0:
        return np.zeros_like(np.asarray(lam_nm, np.float64))
    c = 299792458.0
    h = 6.62606957e-34
    kb = 1.3806488e-23
    l = np.asarray(lam_nm, np.float64) * 1e-9
    return (2.0 * h * c * c) / (l**5 * (np.exp((h * c) / (l * kb * t)) - 1.0))


def planck_device(lam_nm, t):
    """Planck's law on the device in float32: the 1e-34 constants would
    underflow there, so they are folded (2hc^2 = 1.1910429e-16 W m^2,
    hc/kb = 1.4387770e-2 m K)."""
    l = lam_nm.to(torch.float32) * 1e-9
    l5 = l * l * l * l * l
    return 1.1910429e-16 / (l5 * torch.expm1(1.4387770e-2 / (l * t)))


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
    # name -> (npz key, normalize), as the reference's table.
    "stdillum-D65": ("cie_illum_d6500", True),
    "stdillum-D50": ("cie_illum_d5000", True),
    "illum-acesD60": ("aces_illum_d60", True),
    "glass-BK7": ("glass_bk7_eta_samples", False),
    "glass-baf10": ("glass_baf10_eta_samples", False),
    "glass-F11": ("glass_f11_eta_samples", False),
    "metal-Cu-eta": ("cu_eta_samples", False),
    "metal-Cu-k": ("cu_k_samples", False),
    "metal-Au-eta": ("au_eta_samples", False),
    "metal-Au-k": ("au_k_samples", False),
    "metal-Ag-eta": ("ag_eta_samples", False),
    "metal-Ag-k": ("ag_k_samples", False),
    "metal-Al-eta": ("al_eta_samples", False),
    "metal-Al-k": ("al_k_samples", False),
}


@functools.cache
def named_spectrum(name: str) -> PiecewiseLinearSpectrum | None:
    """A named spectrum (illuminants, glass and metal IORs), or None for
    an unknown name."""
    entry = _NAMED_SPECS.get(name)
    if entry is None:
        return None
    key, normalize = entry
    return PiecewiseLinearSpectrum.from_interleaved(_data()[key], normalize)


def swatch_reflectances() -> list[PiecewiseLinearSpectrum]:
    """The 24 BabelColor ColorChecker swatch reflectances."""
    return [PiecewiseLinearSpectrum.from_interleaved(row, False)
            for row in _data()["swatch_reflectances"]]


def d_illuminant(temperature: float) -> DenselySampledSpectrum:
    """The CIE D illuminant of a correlated color temperature (a
    blackbody below 4000 K)."""
    cct = temperature * 1.4388 / 1.4380
    if cct < 4000.0:
        return DenselySampledSpectrum(BlackbodySpectrum(cct).to_dense())
    if cct <= 7000.0:
        x = -4.607e9 / cct**3 + 2.9678e6 / cct**2 + 0.09911e3 / cct + 0.244063
    else:
        x = -2.0064e9 / cct**3 + 1.9018e6 / cct**2 + 0.24748e3 / cct + 0.23704
    y = -3.0 * x * x + 2.870 * x - 0.275
    m = 0.0241 + 0.2562 * x - 0.7341 * y
    m1 = (-1.3515 - 1.7703 * x + 5.9114 * y) / m
    m2 = (0.0300 - 31.4424 * x + 30.0717 * y) / m
    d = _data()
    values = (d["cie_s0"] + d["cie_s1"] * m1 + d["cie_s2"] * m2) * 0.01
    return DenselySampledSpectrum(PiecewiseLinearSpectrum(d["cie_s_lambda"], values).to_dense())


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
