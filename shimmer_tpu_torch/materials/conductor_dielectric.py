"""Conductor, dielectric and thin-dielectric BxDFs, smooth and rough (port
of ``shimmer_tpu/materials/conductor_dielectric.py``).

Everything is batched over lanes in the local shading frame; the
effectively-smooth specular case and the rough microfacet case are both
computed and selected per lane.  Spectral conductor IORs (eta, k per hero
wavelength) come from the scene's dense spectra table; the reflectance
parameterization converts to eta = 1, k = 2 sqrt(R) / sqrt(1 - R).  A
dielectric's eta is one number per lane: a spectral eta is read at the
hero wavelength (the dispersion hook has collapsed the path to it).
"""

from __future__ import annotations

import torch

from shimmer_tpu_torch.config import const_f32
from shimmer_tpu_torch.materials import bxdf as bx
from shimmer_tpu_torch.materials import scattering as sc
from shimmer_tpu_torch.materials.bxdf import BSDFSample, select_sample
from shimmer_tpu_torch.ops.math import safe_div, safe_sqrt, sqr, sqrt, small_gather
from shimmer_tpu_torch.ops.vecmath import (
    abs_cos_theta,
    abs_dot,
    cos_theta,
    dot,
    normalize,
    same_hemisphere,
)
from shimmer_tpu_torch.spectra.rgb2spec import sigmoid_poly_sample
from shimmer_tpu_torch.spectra.spectrum import dense_sample_rows

# Material kinds this module dispatches (materials/material.py's numbering).
CONDUCTOR = 1
DIELECTRIC = 2
THIN_DIELECTRIC = 3


def _full(batch, value, dtype, device):
    return torch.full(batch, value, dtype=dtype, device=device)


def _plus_z(like):
    return const_f32((0.0, 0.0, 1.0), like.device).expand(like.shape)


def _mirror(wo):
    return torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], dim=-1)


def _tex(tex, name):
    """A texture-resolved parameter from the BSDF context, or None."""
    return tex.get(name) if tex else None


def _material_alphas(materials, mat_id, tex=None):
    """(alpha_x, alpha_y): the roughness columns, or their textures; a
    lane flagged in the context's ``regularize`` mask (a path past its
    first non-specular bounce) roughens a near-specular lobe."""
    ax = _tex(tex, "uroughness")
    ay = _tex(tex, "vroughness")
    ax = sc.roughness_to_alpha(small_gather(materials.uroughness, mat_id) if ax is None else ax)
    ay = sc.roughness_to_alpha(small_gather(materials.vroughness, mat_id) if ay is None else ay)
    reg = _tex(tex, "regularize")
    if reg is not None:
        ax = torch.where(reg, sc.regularize_alpha(ax), ax)
        ay = torch.where(reg, sc.regularize_alpha(ay), ay)
    return sc.clamp_alpha(ax, ay)


def _conductor_eta_k(materials, mat_id, lam, spectra_table, tex=None):
    """Per-wavelength (eta, k) at wavelengths ``lam``: dense-spectrum rows
    or reflectance mode (the reflectance column, or its texture)."""
    eta_idx = small_gather(materials.eta_spec, mat_id)
    k_idx = small_gather(materials.k_spec, mat_id)
    use_spec = (eta_idx >= 0)[..., None]
    if spectra_table is not None:
        eta_s = dense_sample_rows(spectra_table, torch.clamp(eta_idx, min=0), lam)
        k_s = dense_sample_rows(spectra_table, torch.clamp(k_idx, min=0), lam)
    else:
        eta_s = torch.ones_like(lam)
        k_s = torch.ones_like(lam)
    refl = _tex(tex, "reflectance")
    if refl is None:
        refl = sigmoid_poly_sample(small_gather(materials.reflectance, mat_id), lam)
    refl = torch.clamp(refl, 0.0, 0.9999)
    k_r = 2.0 * sqrt(refl) / safe_sqrt(1.0 - refl)
    return torch.where(use_spec, eta_s, 1.0), torch.where(use_spec, k_s, k_r)


def _dielectric_eta(materials, mat_id, lam, spectra_table):
    """Relative IOR per lane; a spectral eta at the hero wavelength of
    ``lam``."""
    eta_idx = small_gather(materials.eta_spec, mat_id)
    eta_f = small_gather(materials.eta_float, mat_id)
    if spectra_table is None:
        return eta_f
    eta_s = dense_sample_rows(spectra_table, torch.clamp(eta_idx, min=0), lam)[..., 0]
    return torch.where(eta_idx >= 0, eta_s, eta_f)


def _half_vector(wm):
    """Normalized half vector and where it is defined."""
    ok = torch.sum(wm * wm, -1) > 1e-18
    return normalize(torch.where(ok[..., None], wm, _plus_z(wm))), ok


# --- conductor ---


def conductor_f(eta, k, wo, wi, ax, ay):
    smooth = sc.effectively_smooth(ax, ay)
    same = same_hemisphere(wo, wi)
    cos_o = abs_cos_theta(wo)
    cos_i = abs_cos_theta(wi)
    wm, wm_ok = _half_vector(wi + wo)
    fr = sc.fresnel_complex(abs_dot(wo, wm)[..., None], eta, k)
    d = sc.tr_d(wm, ax, ay)
    g = sc.tr_g(wo, wi, ax, ay)
    denom = torch.clamp(4.0 * cos_o * cos_i, min=1e-9)
    f = (d * g / denom)[..., None] * fr
    ok = same & ~smooth & wm_ok & (cos_o > 1e-9) & (cos_i > 1e-9)
    return torch.where(ok[..., None], f, 0.0)


def conductor_sample(eta, k, wo, u2, ax, ay):
    batch, dev = wo.shape[:-1], wo.device
    smooth = sc.effectively_smooth(ax, ay)
    # smooth: perfect mirror
    wi_s = _mirror(wo)
    cos_i_s = torch.clamp(abs_cos_theta(wi_s), min=1e-9)
    smooth_sample = BSDFSample(
        f=sc.fresnel_complex(cos_i_s[..., None], eta, k) / cos_i_s[..., None],
        wi=wi_s,
        pdf=torch.ones(batch, device=dev),
        flags=_full(batch, bx.SPECULAR_REFLECTION, torch.int32, dev),
        eta=torch.ones(batch, device=dev),
        pdf_is_proportional=_full(batch, False, torch.bool, dev),
        valid=abs_cos_theta(wo) > 1e-9,
    )
    # rough: visible-normal sampling
    wm = sc.tr_sample_wm(wo, u2, ax, ay)
    wi = sc.reflect(wo, wm)
    same = same_hemisphere(wo, wi)
    pdf = sc.tr_pdf(wo, wm, ax, ay) / torch.clamp(4.0 * abs_dot(wo, wm), min=1e-9)
    cos_o = torch.clamp(abs_cos_theta(wo), min=1e-9)
    cos_i = torch.clamp(abs_cos_theta(wi), min=1e-9)
    fr = sc.fresnel_complex(abs_dot(wo, wm)[..., None], eta, k)
    d = sc.tr_d(wm, ax, ay)
    g = sc.tr_g(wo, wi, ax, ay)
    rough = BSDFSample(
        f=(d * g / (4.0 * cos_o * cos_i))[..., None] * fr,
        wi=wi,
        pdf=pdf,
        flags=_full(batch, bx.GLOSSY_REFLECTION, torch.int32, dev),
        eta=torch.ones(batch, device=dev),
        pdf_is_proportional=_full(batch, False, torch.bool, dev),
        valid=same & (pdf > 0.0),
    )
    return select_sample(smooth, smooth_sample, rough)


def conductor_pdf(wo, wi, ax, ay):
    smooth = sc.effectively_smooth(ax, ay)
    same = same_hemisphere(wo, wi)
    wm, wm_ok = _half_vector(wi + wo)
    wm = torch.where((wm[..., 2] < 0)[..., None], -wm, wm)
    pdf = sc.tr_pdf(wo, wm, ax, ay) / torch.clamp(4.0 * abs_dot(wo, wm), min=1e-9)
    return torch.where(same & ~smooth & wm_ok, pdf, 0.0)


# --- dielectric ---


def _dielectric_half_vector(eta, wo, wi):
    """(cos_o, cos_i, reflect_case, etap, wm, wm_ok, front) of the
    generalized half vector, shared by f and pdf."""
    cos_o = cos_theta(wo)
    cos_i = cos_theta(wi)
    reflect_case = cos_i * cos_o > 0.0
    etap = torch.where(reflect_case, 1.0, torch.where(cos_o > 0, eta, 1.0 / eta))
    wm, wm_ok = _half_vector(wi * etap[..., None] + wo)
    wm = torch.where((wm[..., 2] < 0.0)[..., None], -wm, wm)
    # discard backfacing microfacets
    front = (dot(wm, wi) * cos_i >= 0.0) & (dot(wm, wo) * cos_o >= 0.0)
    return cos_o, cos_i, reflect_case, etap, wm, wm_ok, front


def dielectric_f(eta, wo, wi, ax, ay, radiance=True):
    """Rough dielectric evaluation.  ``radiance`` picks the transport mode:
    radiance applies the 1/etap^2 factor to transmission, importance
    omits it."""
    smooth = sc.effectively_smooth(ax, ay)
    eta_one = torch.abs(eta - 1.0) < 1e-6
    cos_o, cos_i, reflect_case, etap, wm, wm_ok, front = _dielectric_half_vector(eta, wo, wi)
    fr = sc.fresnel_dielectric(dot(wo, wm), eta)
    d = sc.tr_d(wm, ax, ay)
    g = sc.tr_g(wo, wi, ax, ay)
    denom_r = torch.clamp(torch.abs(cos_i * cos_o), min=1e-9)
    f_reflect = d * fr * g / (4.0 * denom_r)
    denom_t = sqr(dot(wi, wm) + dot(wo, wm) / etap)
    denom_t = torch.where(denom_t < 1e-12, 1.0, denom_t)
    f_transmit = (
        d * (1.0 - fr) * g * torch.abs(dot(wi, wm) * dot(wo, wm) / (cos_i * cos_o * denom_t))
    )
    if radiance:
        f_transmit = f_transmit / sqr(etap)
    f = torch.where(reflect_case, f_reflect, f_transmit)
    ok = (
        ~smooth & ~eta_one & wm_ok & front
        & (torch.abs(cos_i) > 1e-9) & (torch.abs(cos_o) > 1e-9)
    )
    return torch.where(ok, f, 0.0)[..., None] * torch.ones(4, device=wo.device)


def _allowed(p, allow):
    return p if allow else torch.zeros_like(p)


def _dielectric_mk(f, wi, pdf, flags, eta, valid):
    batch, dev = wi.shape[:-1], wi.device
    return BSDFSample(
        f=f * torch.ones(4, device=dev),
        wi=wi,
        pdf=pdf,
        flags=_full(batch, flags, torch.int32, dev),
        eta=eta,
        pdf_is_proportional=_full(batch, False, torch.bool, dev),
        valid=valid,
    )


def dielectric_sample(eta, wo, u2, uc, ax, ay, sample_flags=bx.SAMPLE_ALL, radiance=True):
    batch, dev = wo.shape[:-1], wo.device
    smooth = sc.effectively_smooth(ax, ay)
    allow_r = bool(sample_flags & bx.SAMPLE_REFLECTION)
    allow_t = bool(sample_flags & bx.SAMPLE_TRANSMISSION)
    ones = torch.ones(batch, device=dev)

    # ---- smooth specular case ----
    fr_s = sc.fresnel_dielectric(cos_theta(wo), eta)
    pr = _allowed(fr_s, allow_r)
    pt = _allowed(1.0 - fr_s, allow_t)
    total = pr + pt
    choose_r = uc < safe_div(pr, total)
    wi_r = _mirror(wo)
    cos_r = torch.clamp(abs_cos_theta(wi_r), min=1e-9)
    wt, etap_t, t_ok = sc.refract(wo, _plus_z(wo), eta)
    cos_t = torch.clamp(abs_cos_theta(wt), min=1e-9)
    f_t = (1.0 - fr_s) / cos_t
    if radiance:
        f_t = f_t / sqr(etap_t)
    smooth_sample = select_sample(
        choose_r,
        _dielectric_mk((fr_s / cos_r)[..., None], wi_r, safe_div(pr, total),
                       bx.SPECULAR_REFLECTION, ones, (total > 0.0) & (pr > 0.0)),
        _dielectric_mk(f_t[..., None], wt, safe_div(pt, total),
                       bx.SPECULAR_TRANSMISSION, etap_t, (total > 0.0) & (pt > 0.0) & t_ok),
    )

    # ---- rough microfacet case ----
    wm = sc.tr_sample_wm(wo, u2, ax, ay)
    fr_m = sc.fresnel_dielectric(dot(wo, wm), eta)
    pr_m = _allowed(fr_m, allow_r)
    pt_m = _allowed(1.0 - fr_m, allow_t)
    total_m = pr_m + pt_m
    choose_rm = uc < safe_div(pr_m, total_m)
    # reflect branch
    wi_rm = sc.reflect(wo, wm)
    same_rm = same_hemisphere(wo, wi_rm)
    cos_o = cos_theta(wo)
    cos_i_rm = cos_theta(wi_rm)
    d = sc.tr_d(wm, ax, ay)
    g_rm = sc.tr_g(wo, wi_rm, ax, ay)
    pdf_rm = (
        sc.tr_pdf(wo, wm, ax, ay)
        / torch.clamp(4.0 * abs_dot(wo, wm), min=1e-9)
        * safe_div(pr_m, total_m)
    )
    f_rm = (d * g_rm * fr_m / torch.clamp(torch.abs(4.0 * cos_i_rm * cos_o), min=1e-9))[..., None]
    # transmit branch
    wt_m, etap_m, t_ok_m = sc.refract(wo, wm, eta)
    cos_i_tm = cos_theta(wt_m)
    diff_hemi = ~same_hemisphere(wo, wt_m)
    denom = sqr(dot(wt_m, wm) + dot(wo, wm) / etap_m)
    denom_ok = denom > 1e-12
    denom = torch.where(denom_ok, denom, 1.0)
    dwm_dwi = abs_dot(wt_m, wm) / denom
    g_tm = sc.tr_g(wo, wt_m, ax, ay)
    pdf_tm = sc.tr_pdf(wo, wm, ax, ay) * dwm_dwi * safe_div(pt_m, total_m)
    f_tm = (
        d * (1.0 - fr_m) * g_tm
        * torch.abs(dot(wt_m, wm) * dot(wo, wm) / (cos_i_tm * cos_o * denom))
    )
    if radiance:
        f_tm = f_tm / sqr(etap_m)
    rough = select_sample(
        choose_rm,
        _dielectric_mk(f_rm, wi_rm, pdf_rm, bx.GLOSSY_REFLECTION, ones,
                       (total_m > 0.0) & same_rm & (pdf_rm > 0.0)),
        _dielectric_mk(f_tm[..., None], wt_m, pdf_tm, bx.GLOSSY_TRANSMISSION, etap_m,
                       (total_m > 0.0) & t_ok_m & diff_hemi & denom_ok & (pdf_tm > 0.0)),
    )

    # eta == 1 is always a pass-through specular transmission.
    eta_one = torch.abs(eta - 1.0) < 1e-6
    pass_through = _dielectric_mk(
        (1.0 / torch.clamp(abs_cos_theta(-wo), min=1e-9))[..., None], -wo, ones,
        bx.SPECULAR_TRANSMISSION, ones, _full(batch, allow_t, torch.bool, dev),
    )
    return select_sample(eta_one, pass_through, select_sample(smooth, smooth_sample, rough))


def dielectric_pdf(eta, wo, wi, ax, ay, sample_flags=bx.SAMPLE_ALL):
    smooth = sc.effectively_smooth(ax, ay)
    eta_one = torch.abs(eta - 1.0) < 1e-6
    cos_o, cos_i, reflect_case, etap, wm, wm_ok, front = _dielectric_half_vector(eta, wo, wi)
    fr = sc.fresnel_dielectric(dot(wo, wm), eta)
    pr = _allowed(fr, bool(sample_flags & bx.SAMPLE_REFLECTION))
    pt = _allowed(1.0 - fr, bool(sample_flags & bx.SAMPLE_TRANSMISSION))
    total = pr + pt
    pdf_r = (
        sc.tr_pdf(wo, wm, ax, ay)
        / torch.clamp(4.0 * abs_dot(wo, wm), min=1e-9)
        * safe_div(pr, total)
    )
    denom = sqr(dot(wi, wm) + dot(wo, wm) / etap)
    denom_ok = denom > 1e-12
    denom = torch.where(denom_ok, denom, 1.0)
    dwm_dwi = abs_dot(wi, wm) / denom
    pdf_t = sc.tr_pdf(wo, wm, ax, ay) * dwm_dwi * safe_div(pt, total)
    pdf = torch.where(reflect_case, pdf_r, torch.where(denom_ok, pdf_t, 0.0))
    return torch.where(smooth | eta_one | ~wm_ok | ~front, 0.0, pdf)


# --- thin dielectric ---


def thin_dielectric_sample(eta, wo, uc, sample_flags=bx.SAMPLE_ALL):
    batch, dev = wo.shape[:-1], wo.device
    r = sc.fresnel_dielectric(abs_cos_theta(wo), eta)
    # reflectance of the two interfaces, summed over inner bounces
    r = torch.where(r < 1.0, r + sqr(1.0 - r) * r / (1.0 - sqr(r)), 1.0)
    t = 1.0 - r
    pr = _allowed(r, bool(sample_flags & bx.SAMPLE_REFLECTION))
    pt = _allowed(t, bool(sample_flags & bx.SAMPLE_TRANSMISSION))
    total = pr + pt
    choose_r = uc < safe_div(pr, total)
    wi_r = _mirror(wo)
    cos_r = torch.clamp(abs_cos_theta(wi_r), min=1e-9)
    ones = torch.ones(batch, device=dev)
    return select_sample(
        choose_r,
        _dielectric_mk((r / cos_r)[..., None], wi_r, safe_div(pr, total),
                       bx.SPECULAR_REFLECTION, ones, (total > 0.0) & (pr > 0.0)),
        _dielectric_mk((t / torch.clamp(abs_cos_theta(wo), min=1e-9))[..., None], -wo,
                       safe_div(pt, total), bx.SPECULAR_TRANSMISSION, ones,
                       (total > 0.0) & (pt > 0.0)),
    )


# --- dispatch glue used by materials.material ---


def rough_f(materials, kinds_present, mat_id, kind, wo, wi, swl, f, tex=None,
            spectra_table=None):
    if CONDUCTOR in kinds_present:
        ax, ay = _material_alphas(materials, mat_id, tex)
        eta, k = _conductor_eta_k(materials, mat_id, swl.lam, spectra_table, tex)
        f = torch.where((kind == CONDUCTOR)[..., None], conductor_f(eta, k, wo, wi, ax, ay), f)
    if DIELECTRIC in kinds_present:
        ax, ay = _material_alphas(materials, mat_id, tex)
        eta = _dielectric_eta(materials, mat_id, swl.lam, spectra_table)
        f = torch.where((kind == DIELECTRIC)[..., None], dielectric_f(eta, wo, wi, ax, ay), f)
    # THIN_DIELECTRIC is purely specular: f() == 0.
    return f


def rough_sample(materials, kinds_present, mat_id, kind, wo, u2, uc, swl, out, tex=None,
                 spectra_table=None):
    if CONDUCTOR in kinds_present:
        ax, ay = _material_alphas(materials, mat_id, tex)
        eta, k = _conductor_eta_k(materials, mat_id, swl.lam, spectra_table, tex)
        out = select_sample(kind == CONDUCTOR, conductor_sample(eta, k, wo, u2, ax, ay), out)
    if DIELECTRIC in kinds_present:
        ax, ay = _material_alphas(materials, mat_id, tex)
        eta = _dielectric_eta(materials, mat_id, swl.lam, spectra_table)
        out = select_sample(kind == DIELECTRIC, dielectric_sample(eta, wo, u2, uc, ax, ay), out)
    if THIN_DIELECTRIC in kinds_present:
        eta = _dielectric_eta(materials, mat_id, swl.lam, spectra_table)
        out = select_sample(kind == THIN_DIELECTRIC, thin_dielectric_sample(eta, wo, uc), out)
    return out


def rough_pdf(materials, kinds_present, mat_id, kind, wo, wi, swl, pdf, tex=None,
              spectra_table=None):
    if CONDUCTOR in kinds_present:
        ax, ay = _material_alphas(materials, mat_id, tex)
        pdf = torch.where(kind == CONDUCTOR, conductor_pdf(wo, wi, ax, ay), pdf)
    if DIELECTRIC in kinds_present:
        ax, ay = _material_alphas(materials, mat_id, tex)
        eta = _dielectric_eta(materials, mat_id, swl.lam, spectra_table)
        pdf = torch.where(kind == DIELECTRIC, dielectric_pdf(eta, wo, wi, ax, ay), pdf)
    # thin dielectric: specular only, pdf 0
    return pdf
