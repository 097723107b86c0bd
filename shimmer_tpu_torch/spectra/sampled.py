"""Hero-wavelength sampled spectra (port of ``shimmer_tpu/spectra/sampled.py``).

A sampled spectrum is a plain ``(..., 4)`` float32 tensor; the wavelengths
travel in :class:`SampledWavelengths` with their sampling pdf.
"""

from __future__ import annotations

import dataclasses

import torch

from shimmer_tpu_torch.ops.sampling import (
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
    def sample_visible(u):
        """Importance-sample the 4 hero wavelengths from one u per lane."""
        i = torch.arange(N_SPECTRUM_SAMPLES, dtype=torch.float32, device=u.device)
        up = u[..., None] + i / N_SPECTRUM_SAMPLES
        up = torch.where(up > 1.0, up - 1.0, up)
        lam = sample_visible_wavelengths(up)
        return SampledWavelengths(lam=lam, pdf=visible_wavelengths_pdf(lam))


def ss_is_black(s):
    return torch.all(s == 0.0, dim=-1)
