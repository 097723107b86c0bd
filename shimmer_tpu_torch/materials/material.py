"""Material table and BSDF dispatch (port of
``shimmer_tpu/materials/material.py``).

The set of material kinds in a scene is host metadata: only the BxDF
families present are evaluated, each for all lanes, and selected by kind.
Kinds 0-6 (diffuse, conductor, dielectric, thin dielectric, coated diffuse,
coated conductor, mix) are ported.  Their parameters are the constant
columns, or per-lane values that ``textures.evaluate_material_textures``
resolved from the ``tex_*`` columns (passed as ``tex``); ``normal_tex`` and
``displacement_tex`` drive ``textures.normal_bump``.  Kind 7 (diffuse
transmission) has no BxDF in the reference's dispatch either: it raises
NotImplementedError.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from shimmer_tpu_torch.config import f32, i32, resolve_device
from shimmer_tpu_torch.materials import bxdf as bx
from shimmer_tpu_torch.materials import conductor_dielectric as cd
from shimmer_tpu_torch.materials import layered
from shimmer_tpu_torch.materials.bxdf import BSDFSample, select_sample
from shimmer_tpu_torch.ops.math import small_gather
from shimmer_tpu_torch.ops.sampling import UNIFORM_HEMISPHERE_PDF, sample_uniform_hemisphere
from shimmer_tpu_torch.spectra.rgb2spec import sigmoid_poly_sample
from shimmer_tpu_torch.textures.textures import textured_params
from shimmer_tpu_torch.utils import stats

DIFFUSE = 0
CONDUCTOR = cd.CONDUCTOR
DIELECTRIC = cd.DIELECTRIC
THIN_DIELECTRIC = cd.THIN_DIELECTRIC
COATED_DIFFUSE = layered.COATED_DIFFUSE
COATED_CONDUCTOR = layered.COATED_CONDUCTOR
MIX = 6
DIFFUSE_TRANSMISSION = 7

# The dispatch's entry points (bsdf_f, bsdf_sample, bsdf_pdf, resolve_mix)
# run inside material/eval, /sample, /pdf and /mix spans, and each BxDF
# family they enter inside a span of its own.
_DIFFUSE_SPAN = stats.span("material/diffuse")
_CD_SPAN = stats.span("material/conductor_dielectric")
_LAYERED_SPAN = stats.span("material/layered")

PORTED_KINDS = (DIFFUSE, CONDUCTOR, DIELECTRIC, THIN_DIELECTRIC, COATED_DIFFUSE,
                COATED_CONDUCTOR, MIX)
# Texture-id columns (-1: no texture).
TEXTURE_COLUMNS = ("tex_mix_amount", "tex_reflectance", "tex_uroughness", "tex_vroughness",
                   "normal_tex", "displacement_tex")


@dataclasses.dataclass(frozen=True)
class MaterialTable:
    """Flat per-material parameter columns (the reference's columns)."""

    kind: torch.Tensor             # (M,) int32
    reflectance: torch.Tensor      # (M, 3) sigmoid coefficients (diffuse, coated, conductor)
    eta_spec: torch.Tensor         # (M,) int32 row of the spectra table, -1 = eta_float
    k_spec: torch.Tensor           # (M,) int32
    eta_float: torch.Tensor        # (M,)
    uroughness: torch.Tensor       # (M,)
    vroughness: torch.Tensor       # (M,)
    mix_amount: torch.Tensor       # (M,)
    mix_m1: torch.Tensor           # (M,) int32
    mix_m2: torch.Tensor           # (M,) int32
    tex_mix_amount: torch.Tensor   # (M,) int32 texture id, -1 = none
    tex_reflectance: torch.Tensor  # (M,) int32 texture id, -1 = none
    tex_uroughness: torch.Tensor   # (M,) int32 texture id, -1 = none
    tex_vroughness: torch.Tensor   # (M,) int32 texture id, -1 = none
    normal_tex: torch.Tensor       # (M,) int32 texture id, -1 = none
    displacement_tex: torch.Tensor  # (M,) int32 texture id, -1 = none
    thickness: torch.Tensor        # (M,) coat layer optical thickness
    hg_g: torch.Tensor             # (M,) HG asymmetry of the layer medium
    albedo: torch.Tensor           # (M, 3) sigmoid coefficients of the medium albedo
    bot_uroughness: torch.Tensor   # (M,) coated conductor's bottom roughness
    bot_vroughness: torch.Tensor   # (M,)
    dispersive: torch.Tensor       # (M,) bool: dielectric with a spectral eta
    # --- census ---
    has_textured_mix: bool = False
    layer_medium: bool = False     # a coat's layer has a scattering medium
    has_dispersion: bool = False   # a dispersive dielectric exists
    # Parameters some material takes from a texture ("reflectance",
    # "uroughness", "vroughness").
    textured_params: tuple = ()


def check_kinds(kinds_present: tuple):
    bad = [k for k in kinds_present if k not in PORTED_KINDS]
    if bad:
        raise NotImplementedError(f"material kinds {bad} are not ported yet")


def make_material_table(mats: list[dict], device=None) -> MaterialTable:
    """Host: build the table from material dicts (``kind`` plus per-kind
    parameters, the reference's keys and defaults) on ``device`` (default:
    the CUDA card)."""
    check_kinds(tuple(int(m.get("kind", DIFFUSE)) for m in mats))
    device = resolve_device(device)

    def col(key, default, dtype):
        return np.array([m.get(key, default) for m in mats], dtype).reshape(len(mats))

    def coeffs(key):
        if not mats:
            return np.zeros((0, 3), np.float32)
        return np.stack([np.asarray(m.get(key, [0.0, 0.0, 0.0]), np.float32) for m in mats])

    kind = col("kind", DIFFUSE, np.int32)
    textures = {name: col(name, -1, np.int32) for name in TEXTURE_COLUMNS}
    refl = coeffs("reflectance_coeffs")
    albedo = coeffs("albedo_coeffs")
    eta_spec = col("eta_spec", -1, np.int32)
    is_coated = (kind == COATED_DIFFUSE) | (kind == COATED_CONDUCTOR)
    # A spectral eta on a dielectric is dispersive (constant etas are
    # stored as eta_float).
    dispersive = ((kind == DIELECTRIC) | (kind == THIN_DIELECTRIC)) & (eta_spec >= 0)
    return MaterialTable(
        kind=i32(kind, device),
        reflectance=f32(refl, device),
        eta_spec=i32(eta_spec, device),
        k_spec=i32(col("k_spec", -1, np.int32), device),
        eta_float=f32(col("eta_float", 1.5, np.float32), device),
        uroughness=f32(col("uroughness", 0.0, np.float32), device),
        vroughness=f32(col("vroughness", 0.0, np.float32), device),
        mix_amount=f32(col("mix_amount", 0.5, np.float32), device),
        mix_m1=i32(col("mix_m1", 0, np.int32), device),
        mix_m2=i32(col("mix_m2", 0, np.int32), device),
        **{name: i32(v, device) for name, v in textures.items()},
        thickness=f32(col("thickness", 0.01, np.float32), device),
        hg_g=f32(col("g", 0.0, np.float32), device),
        albedo=f32(albedo, device),
        bot_uroughness=f32(col("bot_uroughness", 0.0, np.float32), device),
        bot_vroughness=f32(col("bot_vroughness", 0.0, np.float32), device),
        dispersive=torch.from_numpy(dispersive).to(device),
        has_textured_mix=bool(np.any(textures["tex_mix_amount"] >= 0)),
        layer_medium=bool(np.any(np.abs(albedo[is_coated]) > 0.0)),
        has_dispersion=bool(np.any(dispersive)),
        textured_params=textured_params(textures),
    )


@stats.span("material/mix")
def resolve_mix(materials: MaterialTable, kinds_present: tuple, mat_id, u, amt_override=None):
    """Resolve mix materials to a concrete material id: m1 with
    probability ``amount``.  Two rounds resolve a mix of mixes.
    ``amt_override`` is a per-lane amount (a float texture evaluated at the
    hit) for the first round; a nested mix uses its constant column."""
    if MIX not in kinds_present:
        return mat_id
    for round_i in range(2):
        is_mix = small_gather(materials.kind, mat_id) == MIX
        amt = small_gather(materials.mix_amount, mat_id)
        if round_i == 0 and amt_override is not None:
            amt = amt_override
        chosen = torch.where(u < amt, small_gather(materials.mix_m1, mat_id),
                             small_gather(materials.mix_m2, mat_id))
        mat_id = torch.where(is_mix, chosen, mat_id)
    return mat_id


def resolved_kinds(kinds_present: tuple) -> tuple:
    """Kinds that can reach BSDF dispatch after mix resolution."""
    return tuple(k for k in kinds_present if k != MIX)


def _diffuse_reflectance(materials, mat_id, swl, tex=None):
    if tex and tex.get("reflectance") is not None:
        return tex["reflectance"]
    return sigmoid_poly_sample(small_gather(materials.reflectance, mat_id), swl.lam)


def _rng_key(rng_key, like):
    return rng_key if rng_key is not None else torch.zeros(like.shape[:-1], dtype=torch.int64,
                                                           device=like.device)


def _any(kinds_present, *kinds):
    return any(k in kinds_present for k in kinds)


@stats.span("material/eval")
def bsdf_f(materials, kinds_present, mat_id, frame, ns, wo_render, wi_render, swl,
           tex=None, spectra_table=None, rng_key=None):
    """Render-space BSDF value over lanes."""
    check_kinds(kinds_present)
    wo = frame.to_local(wo_render)
    wi = frame.to_local(wi_render)
    kind = small_gather(materials.kind, mat_id)
    f = torch.zeros(wo.shape[:-1] + (4,), device=wo.device)
    if DIFFUSE in kinds_present:
        with _DIFFUSE_SPAN:
            refl = _diffuse_reflectance(materials, mat_id, swl, tex)
            f = torch.where((kind == DIFFUSE)[..., None], bx.diffuse_f(refl, wo, wi), f)
    if _any(kinds_present, CONDUCTOR, DIELECTRIC):
        with _CD_SPAN:
            f = cd.rough_f(materials, kinds_present, mat_id, kind, wo, wi, swl, f,
                           tex=tex, spectra_table=spectra_table)
    if _any(kinds_present, COATED_DIFFUSE, COATED_CONDUCTOR):
        with _LAYERED_SPAN:
            f = layered.coated_f(materials, kinds_present, mat_id, kind, wo, wi, swl, f,
                                 _rng_key(rng_key, wo), tex=tex, spectra_table=spectra_table)
    return torch.where((torch.abs(wo[..., 2]) < 1e-9)[..., None], 0.0, f)


@stats.span("material/sample")
def bsdf_sample(materials, kinds_present, mat_id, frame, ns, wo_render, u2, uc, swl,
                tex=None, spectra_table=None, rng_key=None) -> BSDFSample:
    """Render-space BSDF sampling; ``wi`` comes back in render space."""
    check_kinds(kinds_present)
    wo = frame.to_local(wo_render)
    kind = small_gather(materials.kind, mat_id)
    out = BSDFSample.invalid(wo.shape[:-1], wo.device)
    if DIFFUSE in kinds_present:
        with _DIFFUSE_SPAN:
            refl = _diffuse_reflectance(materials, mat_id, swl, tex)
            out = select_sample(kind == DIFFUSE, bx.diffuse_sample_f(refl, wo, u2, uc), out)
    if _any(kinds_present, CONDUCTOR, DIELECTRIC, THIN_DIELECTRIC):
        with _CD_SPAN:
            out = cd.rough_sample(materials, kinds_present, mat_id, kind, wo, u2, uc, swl, out,
                                  tex=tex, spectra_table=spectra_table)
    if _any(kinds_present, COATED_DIFFUSE, COATED_CONDUCTOR):
        with _LAYERED_SPAN:
            out = layered.coated_sample(materials, kinds_present, mat_id, kind, wo, u2, uc,
                                        swl, out, _rng_key(rng_key, wo), tex=tex,
                                        spectra_table=spectra_table)
    degenerate = torch.abs(wo[..., 2]) < 1e-9
    return dataclasses.replace(
        out, wi=frame.from_local(out.wi), valid=out.valid & ~degenerate & (out.pdf > 0.0)
    )


@stats.span("material/pdf")
def bsdf_pdf(materials, kinds_present, mat_id, frame, ns, wo_render, wi_render, swl,
             tex=None, spectra_table=None, rng_key=None):
    """Render-space BSDF pdf."""
    check_kinds(kinds_present)
    wo = frame.to_local(wo_render)
    wi = frame.to_local(wi_render)
    kind = small_gather(materials.kind, mat_id)
    pdf = torch.zeros(wo.shape[:-1], device=wo.device)
    if DIFFUSE in kinds_present:
        with _DIFFUSE_SPAN:
            pdf = torch.where(kind == DIFFUSE, bx.diffuse_pdf(wo, wi), pdf)
    if _any(kinds_present, CONDUCTOR, DIELECTRIC):
        with _CD_SPAN:
            pdf = cd.rough_pdf(materials, kinds_present, mat_id, kind, wo, wi, swl, pdf,
                               tex=tex, spectra_table=spectra_table)
    if _any(kinds_present, COATED_DIFFUSE, COATED_CONDUCTOR):
        with _LAYERED_SPAN:
            pdf = layered.coated_pdf(materials, kinds_present, mat_id, kind, wo, wi, swl, pdf,
                                     _rng_key(rng_key, wo), tex=tex,
                                     spectra_table=spectra_table)
    return torch.where(torch.abs(wo[..., 2]) < 1e-9, 0.0, pdf)


def bsdf_rho_hd(materials, kinds_present, mat_id, frame, ns, wo_render, swl, uc, u2, **ctx):
    """Hemispherical-directional reflectance rho_hd (pbrt-v4 eq. 4.12):
    a Monte Carlo estimate over the given samples, uc (S, ...) and
    u2 (S, ..., 2).  Returns (..., 4)."""
    s_count = uc.shape[0]
    r = torch.zeros(wo_render.shape[:-1] + (4,), device=wo_render.device)
    for i in range(s_count):
        bs = bsdf_sample(materials, kinds_present, mat_id, frame, ns, wo_render, u2[i], uc[i],
                         swl, **ctx)
        cos_i = torch.abs(frame.to_local(bs.wi)[..., 2])
        ok = bs.valid & (bs.pdf > 0.0)
        r = r + torch.where(
            ok[..., None], bs.f * (cos_i / torch.clamp(bs.pdf, min=1e-20))[..., None], 0.0
        )
    return r / float(s_count)


def bsdf_rho_hh(materials, kinds_present, mat_id, frame, ns, swl, u1, uc, u2, **ctx):
    """Hemispherical-hemispherical reflectance rho_hh (pbrt-v4 eq. 4.13):
    wo uniform over the hemisphere of the shading normal (u1 (S, ..., 2)),
    then the rho_hd estimate."""
    s_count = uc.shape[0]
    r = torch.zeros(u1.shape[1:-1] + (4,), device=u1.device)
    for i in range(s_count):
        wo_local = sample_uniform_hemisphere(u1[i])
        wo_render = frame.from_local(wo_local)
        bs = bsdf_sample(materials, kinds_present, mat_id, frame, ns, wo_render, u2[i], uc[i],
                         swl, **ctx)
        cos_i = torch.abs(frame.to_local(bs.wi)[..., 2])
        cos_o = torch.abs(wo_local[..., 2])
        ok = bs.valid & (bs.pdf > 0.0) & (cos_o > 0.0)
        w = cos_i * cos_o / (UNIFORM_HEMISPHERE_PDF * torch.clamp(bs.pdf, min=1e-20))
        r = r + torch.where(ok[..., None], bs.f * w[..., None], 0.0)
    return r / (float(s_count) * np.pi)
