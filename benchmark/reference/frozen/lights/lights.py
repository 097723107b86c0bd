"""Light sources as a flat SoA table (port of ``shimmer_tpu/lights/lights.py``:
point, spot and distant lights, area lights on spheres, triangles and
bilinear patches, the uniform infinite light and the image infinite light,
whose tables live in ``lights/env.py``).

The light kinds of a scene are host metadata; a kind outside the table
raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference.frozen.lights.env import env_pdf_li, env_sample_li
from benchmark.reference.frozen.ops.math import smooth_step, take_clamped
from benchmark.reference.frozen.ops.sampling import UNIFORM_SPHERE_PDF, sample_uniform_sphere
from benchmark.reference.frozen.ops.vecmath import distance_squared, dot, normalize
from benchmark.reference.frozen.shapes.sphere import sphere_pdf_with_context, sphere_sample_with_context
from benchmark.reference.frozen.spectra.spectrum import dense_sample, dense_sample_rows

POINT = 0
DISTANT = 1
SPOT = 2
AREA = 3
UNIFORM_INFINITE = 4
IMAGE_INFINITE = 5

PORTED_KINDS = (POINT, DISTANT, SPOT, AREA, UNIFORM_INFINITE, IMAGE_INFINITE)
# Area-light shape kinds (the reference's shape_kind column).
SPHERE_SHAPE = 0
TRIANGLE_SHAPE = 1
PATCH_SHAPE = 2


def is_delta_light(kind):
    return (kind == POINT) | (kind == DISTANT) | (kind == SPOT)


@dataclasses.dataclass(frozen=True)
class LightData:
    kind: torch.Tensor          # (L,) int32
    spectrum: torch.Tensor      # (L, 471) dense emission spectrum
    scale: torch.Tensor         # (L,)
    position: torch.Tensor      # (L, 3) point / spot position (render space)
    direction: torch.Tensor     # (L, 3) spot / distant direction (render space)
    cos_falloff_start: torch.Tensor  # (L,) spot: cosine where the falloff starts
    cos_falloff_end: torch.Tensor    # (L,) spot: cosine of the cone's edge
    shape_idx: torch.Tensor     # (L,) int32 area light: sphere / triangle / patch index
    shape_kind: torch.Tensor    # (L,) int32 (0 = sphere, 1 = triangle, 2 = patch)
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


def sample_li(lights: LightData, light_idx, ref_p, ref_ns, u, swl, spheres,
              kinds_present: tuple, tri_sampler=None, env=None,
              patch_sampler=None) -> LightLiSample:
    """Sample an incident direction from light ``light_idx`` per lane;
    ``spheres`` is the scene's SphereData or None, ``env`` its
    EnvLightData or None."""
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

    ones = torch.ones(batch, device=dev)
    if POINT in kinds_present:
        # I / r^2.
        p = take_clamped(lights.position, light_idx)
        d2 = distance_squared(p, ref_p)
        wi = normalize(p - ref_p)
        l = spec / torch.clamp(d2, min=1e-12)[..., None]
        out = sel(kind == POINT, l, wi, ones, p, -wi, d2 > 0.0, out)

    if SPOT in kinds_present:
        # I / r^2 with a smooth falloff between the two cone angles.
        p = take_clamped(lights.position, light_idx)
        d2 = distance_squared(p, ref_p)
        wi = normalize(p - ref_p)
        cos_theta = dot(take_clamped(lights.direction, light_idx), -wi)
        falloff = smooth_step(cos_theta, take_clamped(lights.cos_falloff_end, light_idx),
                              take_clamped(lights.cos_falloff_start, light_idx))
        l = spec * falloff[..., None] / torch.clamp(d2, min=1e-12)[..., None]
        out = sel(kind == SPOT, l, wi, ones, p, -wi, (d2 > 0.0) & (falloff > 0.0), out)

    if DISTANT in kinds_present:
        wi = -take_clamped(lights.direction, light_idx)
        p = ref_p + wi * (2.0 * lights.scene_radius)
        out = sel(kind == DISTANT, spec, wi, ones, p, -wi,
                  torch.ones(batch, dtype=torch.bool, device=dev), out)

    def area(shape_kind, p, n, pdf, cur):
        m = (kind == AREA) & (take_clamped(lights.shape_kind, light_idx) == shape_kind)
        wi = normalize(p - ref_p)
        emits = take_clamped(lights.two_sided, light_idx) | (dot(n, -wi) > 0.0)
        l = torch.where(emits[..., None], spec, 0.0)
        valid = (pdf > 0.0) & (distance_squared(p, ref_p) > 0.0) & emits
        return sel(m, l, wi, pdf, p, n, valid, cur)

    if AREA in kinds_present:
        sidx = take_clamped(lights.shape_idx, light_idx)
        if spheres is not None:
            out = area(SPHERE_SHAPE, *sphere_sample_with_context(spheres, sidx, ref_p, ref_ns, u),
                       out)
        if tri_sampler is not None:
            out = area(TRIANGLE_SHAPE, *tri_sampler(sidx, ref_p, ref_ns, u), out)
        if patch_sampler is not None:
            out = area(PATCH_SHAPE, *patch_sampler(sidx, ref_p, ref_ns, u), out)

    if UNIFORM_INFINITE in kinds_present:
        m = kind == UNIFORM_INFINITE
        wi = sample_uniform_sphere(u)
        p = ref_p + wi * (2.0 * lights.scene_radius)
        pdf = torch.full(batch, UNIFORM_SPHERE_PDF, dtype=torch.float32, device=dev)
        out = sel(m, spec, wi, pdf, p, wi, torch.ones(batch, dtype=torch.bool, device=dev), out)

    if IMAGE_INFINITE in kinds_present and env is not None:
        l, wi, pdf, p = env_sample_li(env, ref_p, u, swl)
        out = sel(kind == IMAGE_INFINITE, l, wi, pdf, p, wi, pdf > 0.0, out)
    return out


def pdf_li(lights: LightData, light_idx, ref_p, ref_ns, wi, si_p, si_n, spheres,
           kinds_present: tuple, tri_pdf=None, env=None, patch_pdf=None):
    """Solid-angle pdf that sample_li would have produced direction wi;
    for area lights, si_p / si_n is the point reached on the light.  A
    delta light's pdf is 0 (no direction reaches it by chance)."""
    check_kinds(kinds_present)
    kind = take_clamped(lights.kind, light_idx)
    pdf = torch.zeros(light_idx.shape, device=ref_p.device)
    sidx = take_clamped(lights.shape_idx, light_idx)
    shape_kind = take_clamped(lights.shape_kind, light_idx)
    if AREA in kinds_present and spheres is not None:
        p = sphere_pdf_with_context(spheres, sidx, ref_p, wi, si_p, si_n)
        pdf = torch.where((kind == AREA) & (shape_kind == SPHERE_SHAPE), p, pdf)
    if AREA in kinds_present and tri_pdf is not None:
        p = tri_pdf(sidx, ref_p, ref_ns, wi, si_p, si_n)
        pdf = torch.where((kind == AREA) & (shape_kind == TRIANGLE_SHAPE), p, pdf)
    if AREA in kinds_present and patch_pdf is not None:
        p = patch_pdf(sidx, ref_p, ref_ns, wi, si_p, si_n)
        pdf = torch.where((kind == AREA) & (shape_kind == PATCH_SHAPE), p, pdf)
    if UNIFORM_INFINITE in kinds_present:
        pdf = torch.where(kind == UNIFORM_INFINITE, UNIFORM_SPHERE_PDF, pdf)
    if IMAGE_INFINITE in kinds_present and env is not None:
        pdf = torch.where(kind == IMAGE_INFINITE, env_pdf_li(env, wi), pdf)
    return pdf


def area_light_l(lights: LightData, light_idx, n, w, swl):
    """Emitted radiance from a point on an area light toward w."""
    emits = take_clamped(lights.two_sided, light_idx) | (dot(n, w) > 0.0)
    return torch.where(emits[..., None], _spectrum_of(lights, light_idx, swl), 0.0)


def infinite_le(lights: LightData, ray_d, swl, uniform_infinite_indices: tuple = (),
                image_infinite_indices: tuple = (), env_eval=None):
    """Sum of the infinite lights' emission toward escaped rays; the index
    lists are the scene's census, so only the kinds present run."""
    total = torch.zeros(ray_d.shape[:-1] + (4,), dtype=torch.float32, device=ray_d.device)
    for i in uniform_infinite_indices:
        total = total + dense_sample(lights.spectrum[i], swl.lam) * lights.scale[i]
    for i in image_infinite_indices:
        total = total + env_eval(i, ray_d, swl)
    return total
