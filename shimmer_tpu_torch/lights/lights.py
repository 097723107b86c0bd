"""Light sources as a flat SoA table (port of ``shimmer_tpu/lights/lights.py``:
triangle area lights and the uniform infinite light).

The light kinds of a scene are host metadata; a scene with a kind the port
has not brought over yet raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses

import torch

from shimmer_tpu_torch.ops.math import take_clamped
from shimmer_tpu_torch.ops.sampling import UNIFORM_SPHERE_PDF, sample_uniform_sphere
from shimmer_tpu_torch.ops.vecmath import distance_squared, dot, normalize
from shimmer_tpu_torch.spectra.spectrum import dense_sample_rows

POINT = 0
DISTANT = 1
SPOT = 2
AREA = 3
UNIFORM_INFINITE = 4

PORTED_KINDS = (AREA, UNIFORM_INFINITE)
TRIANGLE_SHAPE = 1


def is_delta_light(kind):
    return (kind == POINT) | (kind == DISTANT) | (kind == SPOT)


@dataclasses.dataclass(frozen=True)
class LightData:
    kind: torch.Tensor          # (L,) int32
    spectrum: torch.Tensor      # (L, 471) dense emission spectrum
    scale: torch.Tensor         # (L,)
    shape_idx: torch.Tensor     # (L,) int32 area light: triangle index
    shape_kind: torch.Tensor    # (L,) int32 (1 = triangle)
    two_sided: torch.Tensor     # (L,) bool
    scene_radius: torch.Tensor  # ()


@dataclasses.dataclass(frozen=True)
class LightLiSample:
    l: torch.Tensor        # (..., 4)
    wi: torch.Tensor       # (..., 3)
    pdf: torch.Tensor      # (...,) solid-angle pdf
    p_light: torch.Tensor  # (..., 3)
    n_light: torch.Tensor  # (..., 3)
    valid: torch.Tensor    # (...,)
    is_delta: torch.Tensor  # (...,)


def check_kinds(kinds_present: tuple):
    bad = [k for k in kinds_present if k not in PORTED_KINDS]
    if bad:
        raise NotImplementedError(f"light kinds {bad} are not ported yet")


def _spectrum_of(lights, light_idx, swl):
    return dense_sample_rows(lights.spectrum, light_idx, swl.lam) * (
        take_clamped(lights.scale, light_idx)[..., None]
    )


def sample_li(lights: LightData, light_idx, ref_p, ref_ns, u, swl,
              kinds_present: tuple, tri_sampler=None) -> LightLiSample:
    """Sample an incident direction from light ``light_idx`` per lane."""
    check_kinds(kinds_present)
    dev = ref_p.device
    kind = take_clamped(lights.kind, light_idx)
    spec = _spectrum_of(lights, light_idx, swl)
    batch = tuple(light_idx.shape)
    wi0 = torch.zeros(batch + (3,), device=dev)
    wi0[..., 2] = 1.0
    out = LightLiSample(
        l=torch.zeros(batch + (4,), device=dev),
        wi=wi0,
        pdf=torch.zeros(batch, device=dev),
        p_light=torch.zeros(batch + (3,), device=dev),
        n_light=torch.zeros(batch + (3,), device=dev),
        valid=torch.zeros(batch, dtype=torch.bool, device=dev),
        is_delta=is_delta_light(kind),
    )

    def sel(mask, l, wi, pdf, p_light, n_light, valid, cur):
        m1 = mask[..., None]
        return LightLiSample(
            l=torch.where(m1, l, cur.l),
            wi=torch.where(m1, wi, cur.wi),
            pdf=torch.where(mask, pdf, cur.pdf),
            p_light=torch.where(m1, p_light, cur.p_light),
            n_light=torch.where(m1, n_light, cur.n_light),
            valid=torch.where(mask, valid, cur.valid),
            is_delta=cur.is_delta,
        )

    if AREA in kinds_present and tri_sampler is not None:
        tm = (kind == AREA) & (take_clamped(lights.shape_kind, light_idx) == TRIANGLE_SHAPE)
        p, n, pdf = tri_sampler(take_clamped(lights.shape_idx, light_idx), ref_p, ref_ns, u)
        wi = normalize(p - ref_p)
        emits = take_clamped(lights.two_sided, light_idx) | (dot(n, -wi) > 0.0)
        l = torch.where(emits[..., None], spec, 0.0)
        valid = (pdf > 0.0) & (distance_squared(p, ref_p) > 0.0) & emits
        out = sel(tm, l, wi, pdf, p, n, valid, out)

    if UNIFORM_INFINITE in kinds_present:
        m = kind == UNIFORM_INFINITE
        wi = sample_uniform_sphere(u)
        p = ref_p + wi * (2.0 * lights.scene_radius)
        pdf = torch.full(batch, UNIFORM_SPHERE_PDF, dtype=torch.float32, device=dev)
        out = sel(m, spec, wi, pdf, p, wi, torch.ones(batch, dtype=torch.bool, device=dev), out)
    return out


def pdf_li(lights: LightData, light_idx, ref_p, ref_ns, wi, si_p, si_n,
           kinds_present: tuple, tri_pdf=None):
    """Solid-angle pdf that sample_li would have produced direction wi."""
    check_kinds(kinds_present)
    kind = take_clamped(lights.kind, light_idx)
    pdf = torch.zeros(light_idx.shape, device=ref_p.device)
    if AREA in kinds_present and tri_pdf is not None:
        m = (kind == AREA) & (take_clamped(lights.shape_kind, light_idx) == TRIANGLE_SHAPE)
        p = tri_pdf(take_clamped(lights.shape_idx, light_idx), ref_p, ref_ns, wi, si_p, si_n)
        pdf = torch.where(m, p, pdf)
    if UNIFORM_INFINITE in kinds_present:
        pdf = torch.where(kind == UNIFORM_INFINITE, UNIFORM_SPHERE_PDF, pdf)
    return pdf


def area_light_l(lights: LightData, light_idx, n, w, swl):
    """Emitted radiance from a point on an area light toward w."""
    emits = take_clamped(lights.two_sided, light_idx) | (dot(n, w) > 0.0)
    return torch.where(emits[..., None], _spectrum_of(lights, light_idx, swl), 0.0)
