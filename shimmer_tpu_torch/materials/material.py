"""Material table and BSDF dispatch (port of
``shimmer_tpu/materials/material.py``, diffuse kind only).

The set of material kinds in a scene is host metadata; a scene that asks
for a kind the port has not brought over yet raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from shimmer_tpu_torch.config import f32, i32, resolve_device
from shimmer_tpu_torch.materials import bxdf as bx
from shimmer_tpu_torch.materials.bxdf import BSDFSample, select_sample
from shimmer_tpu_torch.ops.math import take_clamped
from shimmer_tpu_torch.spectra.rgb2spec import sigmoid_poly_sample

DIFFUSE = 0
CONDUCTOR = 1
DIELECTRIC = 2
THIN_DIELECTRIC = 3
COATED_DIFFUSE = 4
COATED_CONDUCTOR = 5
MIX = 6
DIFFUSE_TRANSMISSION = 7

PORTED_KINDS = (DIFFUSE,)


@dataclasses.dataclass(frozen=True)
class MaterialTable:
    kind: torch.Tensor         # (M,) int32
    reflectance: torch.Tensor  # (M, 3) sigmoid coefficients


def make_material_table(mats: list[dict], device=None) -> MaterialTable:
    """Host: build the table from material dicts (``kind``,
    ``reflectance_coeffs``) on ``device`` (default: the CUDA card)."""
    for m in mats:
        if int(m.get("kind", DIFFUSE)) not in PORTED_KINDS:
            raise NotImplementedError(
                f"material kind {m.get('kind')} is not ported yet (diffuse only)"
            )
        unported = set(m) - {"kind", "reflectance_coeffs"}
        if unported:
            raise NotImplementedError(f"material parameters {sorted(unported)} are not ported yet")
    device = resolve_device(device)
    refl = (
        np.stack([np.asarray(m.get("reflectance_coeffs", [0.0, 0.0, 0.0]), np.float32) for m in mats])
        if mats
        else np.zeros((0, 3), np.float32)
    )
    return MaterialTable(
        kind=i32([int(m.get("kind", DIFFUSE)) for m in mats], device),
        reflectance=f32(refl, device),
    )


def check_kinds(kinds_present: tuple):
    bad = [k for k in kinds_present if k not in PORTED_KINDS]
    if bad:
        raise NotImplementedError(f"material kinds {bad} are not ported yet")


def _diffuse_reflectance(materials, mat_id, swl):
    return sigmoid_poly_sample(take_clamped(materials.reflectance, mat_id), swl.lam)


def bsdf_f(materials, kinds_present, mat_id, frame, ns, wo_render, wi_render, swl):
    """Render-space BSDF value over lanes."""
    check_kinds(kinds_present)
    wo = frame.to_local(wo_render)
    wi = frame.to_local(wi_render)
    kind = take_clamped(materials.kind, mat_id)
    refl = _diffuse_reflectance(materials, mat_id, swl)
    f = torch.where((kind == DIFFUSE)[..., None], bx.diffuse_f(refl, wo, wi), 0.0)
    return torch.where((torch.abs(wo[..., 2]) < 1e-9)[..., None], 0.0, f)


def bsdf_sample(materials, kinds_present, mat_id, frame, ns, wo_render, u2, uc, swl) -> BSDFSample:
    """Render-space BSDF sampling; ``wi`` comes back in render space."""
    check_kinds(kinds_present)
    wo = frame.to_local(wo_render)
    kind = take_clamped(materials.kind, mat_id)
    out = BSDFSample.invalid(wo.shape[:-1], wo.device)
    refl = _diffuse_reflectance(materials, mat_id, swl)
    out = select_sample(kind == DIFFUSE, bx.diffuse_sample_f(refl, wo, u2), out)
    degenerate = torch.abs(wo[..., 2]) < 1e-9
    return BSDFSample(
        f=out.f,
        wi=frame.from_local(out.wi),
        pdf=out.pdf,
        flags=out.flags,
        eta=out.eta,
        pdf_is_proportional=out.pdf_is_proportional,
        valid=out.valid & ~degenerate & (out.pdf > 0.0),
    )


def bsdf_pdf(materials, kinds_present, mat_id, frame, ns, wo_render, wi_render, swl):
    """Render-space BSDF pdf."""
    check_kinds(kinds_present)
    wo = frame.to_local(wo_render)
    wi = frame.to_local(wi_render)
    kind = take_clamped(materials.kind, mat_id)
    pdf = torch.where(kind == DIFFUSE, bx.diffuse_pdf(wo, wi), 0.0)
    return torch.where(torch.abs(wo[..., 2]) < 1e-9, 0.0, pdf)
