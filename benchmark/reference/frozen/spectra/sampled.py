"""Hero-wavelength sampled spectra (port of ``shimmer_tpu/spectra/sampled.py``).

A sampled spectrum is a plain ``(..., 4)`` float32 tensor; the wavelengths
travel in :class:`SampledWavelengths` with their sampling pdf.
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference.frozen.ops.math import lerp, safe_div
from benchmark.reference.frozen.ops.sampling import (
    sample_visible_wavelengths,
    visible_wavelengths_pdf,
)

N_SPECTRUM_SAMPLES = 4
LAMBDA_MIN = 360.0
LAMBDA_MAX = 830.0


@dataclasses.dataclass(frozen=True)
class SampledWavelengths:
    lam: torch.Tensor  # (..., 4)
    pdf: torch.Tensor  # (..., 4)

    @staticmethod
    def sample_uniform(u, lambda_min=LAMBDA_MIN, lambda_max=LAMBDA_MAX):
        """Wavelengths stratified over [min, max] from one u per lane,
        wrapped past the top."""
        first = lerp(u, lambda_min, lambda_max)
        delta = (lambda_max - lambda_min) / N_SPECTRUM_SAMPLES
        i = torch.arange(N_SPECTRUM_SAMPLES, dtype=torch.float32, device=u.device)
        lam = first[..., None] + i * delta
        lam = torch.where(lam > lambda_max, lambda_min + (lam - lambda_max), lam)
        pdf = torch.full_like(lam, 1.0 / (lambda_max - lambda_min))
        return SampledWavelengths(lam=lam, pdf=pdf)

    @staticmethod
    def sample_visible(u):
        """Importance-sample the 4 hero wavelengths from one u per lane."""
        i = torch.arange(N_SPECTRUM_SAMPLES, dtype=torch.float32, device=u.device)
        up = u[..., None] + i / N_SPECTRUM_SAMPLES
        up = torch.where(up > 1.0, up - 1.0, up)
        lam = sample_visible_wavelengths(up)
        return SampledWavelengths(lam=lam, pdf=visible_wavelengths_pdf(lam))


def ss_const(value, batch_shape=(), device=None):
    return torch.full(tuple(batch_shape) + (N_SPECTRUM_SAMPLES,), value, dtype=torch.float32,
                      device=device)


def ss_average(s):
    return torch.mean(s, dim=-1)


def ss_safe_div(a, b):
    return safe_div(a, b)


def ss_is_black(s):
    return torch.all(s == 0.0, dim=-1)


def ss_max_component(s):
    return torch.max(s, dim=-1).values
