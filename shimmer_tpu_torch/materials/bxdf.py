"""BxDF core: flags, sample records and the Lambertian diffuse BxDF (port
of ``shimmer_tpu/materials/bxdf.py``).  BxDFs are functions over parameter
tensors in the local shading frame (z = shading normal); conductor,
dielectric, thin dielectric and the layered coats live in sibling
modules."""

from __future__ import annotations

import dataclasses

import torch

from shimmer_tpu_torch.config import const_f32
from shimmer_tpu_torch.ops.sampling import (
    INV_PI,
    cosine_hemisphere_pdf,
    sample_cosine_hemisphere,
)
from shimmer_tpu_torch.ops.vecmath import abs_cos_theta, same_hemisphere
from shimmer_tpu_torch.spectra.sampled import N_SPECTRUM_SAMPLES

REFLECTION = 1
TRANSMISSION = 2
DIFFUSE = 4
GLOSSY = 8
SPECULAR = 16
DIFFUSE_REFLECTION = DIFFUSE | REFLECTION
DIFFUSE_TRANSMISSION = DIFFUSE | TRANSMISSION
GLOSSY_REFLECTION = GLOSSY | REFLECTION
GLOSSY_TRANSMISSION = GLOSSY | TRANSMISSION
SPECULAR_REFLECTION = SPECULAR | REFLECTION
SPECULAR_TRANSMISSION = SPECULAR | TRANSMISSION
ALL = REFLECTION | TRANSMISSION | DIFFUSE | GLOSSY | SPECULAR

# Sample-request flags (which hemispheres a sample may take).
SAMPLE_REFLECTION = 1
SAMPLE_TRANSMISSION = 2
SAMPLE_ALL = SAMPLE_REFLECTION | SAMPLE_TRANSMISSION


def flags_is_specular(flags):
    return (flags & SPECULAR) != 0


@dataclasses.dataclass(frozen=True)
class BSDFSample:
    f: torch.Tensor                    # (..., 4)
    wi: torch.Tensor                   # (..., 3)
    pdf: torch.Tensor                  # (...,)
    flags: torch.Tensor                # (...,) int32
    eta: torch.Tensor                  # (...,)
    pdf_is_proportional: torch.Tensor  # (...,) bool
    valid: torch.Tensor                # (...,) bool

    @staticmethod
    def invalid(batch_shape, device):
        z = torch.zeros(batch_shape, dtype=torch.float32, device=device)
        wi = torch.zeros(tuple(batch_shape) + (3,), dtype=torch.float32, device=device)
        wi[..., 2] = 1.0
        return BSDFSample(
            f=torch.zeros(tuple(batch_shape) + (N_SPECTRUM_SAMPLES,), device=device),
            wi=wi,
            pdf=z,
            flags=torch.zeros(batch_shape, dtype=torch.int32, device=device),
            eta=torch.ones(batch_shape, dtype=torch.float32, device=device),
            pdf_is_proportional=torch.zeros(batch_shape, dtype=torch.bool, device=device),
            valid=torch.zeros(batch_shape, dtype=torch.bool, device=device),
        )

    def is_specular(self):
        return flags_is_specular(self.flags)


def select_sample(cond, a: BSDFSample, b: BSDFSample) -> BSDFSample:
    """Lane-wise select between two BSDF samples."""
    c1 = cond[..., None]
    return BSDFSample(
        f=torch.where(c1, a.f, b.f),
        wi=torch.where(c1, a.wi, b.wi),
        pdf=torch.where(cond, a.pdf, b.pdf),
        flags=torch.where(cond, a.flags, b.flags),
        eta=torch.where(cond, a.eta, b.eta),
        pdf_is_proportional=torch.where(cond, a.pdf_is_proportional, b.pdf_is_proportional),
        valid=torch.where(cond, a.valid, b.valid),
    )


def diffuse_f(reflectance, wo, wi):
    """Lambertian: R/pi when wo and wi share a hemisphere."""
    return torch.where(same_hemisphere(wo, wi)[..., None], reflectance * INV_PI, 0.0)


def diffuse_sample_f(reflectance, wo, u, uc=None, sample_flags=SAMPLE_ALL) -> BSDFSample:
    """Cosine-weighted hemisphere sampling, flipped into wo's hemisphere."""
    batch = wo.shape[:-1]
    if not sample_flags & SAMPLE_REFLECTION:
        return BSDFSample.invalid(batch, wo.device)
    wi = sample_cosine_hemisphere(u)
    flip = const_f32((1.0, 1.0, -1.0), wo.device)
    wi = torch.where((wo[..., 2] < 0.0)[..., None], wi * flip, wi)
    pdf = cosine_hemisphere_pdf(abs_cos_theta(wi))
    return BSDFSample(
        f=reflectance * INV_PI,
        wi=wi,
        pdf=pdf,
        flags=torch.full(batch, DIFFUSE_REFLECTION, dtype=torch.int32, device=wo.device),
        eta=torch.ones(batch, dtype=torch.float32, device=wo.device),
        pdf_is_proportional=torch.zeros(batch, dtype=torch.bool, device=wo.device),
        valid=pdf > 0.0,
    )


def diffuse_pdf(wo, wi, sample_flags=SAMPLE_ALL):
    pdf = torch.where(same_hemisphere(wo, wi), cosine_hemisphere_pdf(abs_cos_theta(wi)), 0.0)
    return pdf * (1.0 if sample_flags & SAMPLE_REFLECTION else 0.0)
