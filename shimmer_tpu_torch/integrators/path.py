"""Path-integrator helpers that the wavefront loop uses (port of the
helpers ``shimmer_tpu/integrators/wavefront.py`` imports from
``shimmer_tpu/integrators/path.py``).

For a scene with textures, the hit-preparation hook sets the texture
footprints from the camera's pixel spread and applies normal and bump
maps; the BSDF context carries the per-lane texture-driven parameters.
A scene without textures skips both, as the footprints feed textures
only.

For a scene with media: the free-flight sampling over a traced segment
(``_medium_segment``), next-event estimation from a medium vertex
(``sample_ld_medium_prepare``) and the shadow march through material-less
interface shapes (``shadow_march_interfaces``).
"""

from __future__ import annotations

import dataclasses

import torch

from shimmer_tpu_torch.lights import lights as lt
from shimmer_tpu_torch.lights.env import env_le, env_pdf_li
from shimmer_tpu_torch.materials import material as mtl
from shimmer_tpu_torch.materials.material import bsdf_f, bsdf_pdf
from shimmer_tpu_torch.ops import rng as srng
from shimmer_tpu_torch.ops.math import small_gather
from shimmer_tpu_torch.ops.ray import offset_ray_origin
from shimmer_tpu_torch.ops.sampling import UNIFORM_SPHERE_PDF, power_heuristic
from shimmer_tpu_torch.materials.scattering import henyey_greenstein
from shimmer_tpu_torch.media import medium_sigma
from shimmer_tpu_torch.ops.vecmath import abs_dot, dot, length, normalize
from shimmer_tpu_torch.scene import Scene, light_pmf, sample_light, scene_intersect
from shimmer_tpu_torch.shapes.bilinear import bilinear_light_pdf, bilinear_light_sample
from shimmer_tpu_torch.shapes.triangle import triangle_light_pdf, triangle_light_sample
from shimmer_tpu_torch.spectra.sampled import N_SPECTRUM_SAMPLES, ss_is_black
from shimmer_tpu_torch.spectra.spectrum import dense_sample
from shimmer_tpu_torch.textures.normal_bump import apply_normal_bump
from shimmer_tpu_torch.textures.textures import eval_float_texture, evaluate_material_textures

INF = float("inf")


def _tri_sampler(scene):
    if not scene.has_triangles:
        return None
    return lambda sidx, ref_p, ref_ns, u: triangle_light_sample(
        scene.triangles, sidx, ref_p, ref_ns, u
    )


def _tri_pdf(scene):
    if not scene.has_triangles:
        return None
    return lambda sidx, ref_p, ref_ns, wi, si_p, si_n: triangle_light_pdf(
        scene.triangles, sidx, ref_p, ref_ns, wi, si_p, si_n
    )


def _patch_sampler(scene):
    if not scene.has_patches:
        return None
    return lambda sidx, ref_p, ref_ns, u: bilinear_light_sample(
        scene.patches, sidx, ref_p, ref_ns, u
    )


def _patch_pdf(scene):
    if not scene.has_patches:
        return None
    return lambda sidx, ref_p, ref_ns, wi, si_p, si_n: bilinear_light_pdf(
        scene.patches, sidx, ref_p, ref_ns, wi, si_p, si_n
    )


def _area_le_with_mis(scene, si, swl, beta, p_b, specular, prev_p, prev_ns, l, alive):
    """Emission from an emissive hit, MIS-weighted against NEE."""
    has_light = alive & si.valid & (si.area_light_id >= 0)
    lid = torch.clamp(si.area_light_id, min=0)
    le = lt.area_light_l(scene.lights, lid, si.n, si.wo, swl)
    pdf_l = light_pmf(scene, lid) * lt.pdf_li(
        scene.lights, lid, prev_p, prev_ns, normalize(si.p - prev_p), si.p, si.n,
        scene.spheres, scene.light_kinds, tri_pdf=_tri_pdf(scene), env=scene.env,
        patch_pdf=_patch_pdf(scene),
    )
    w = torch.where(specular, 1.0, power_heuristic(1.0, p_b, 1.0, pdf_l))
    return l + torch.where(has_light[..., None], beta * w[..., None] * le, 0.0)


def _infinite_le_with_mis(scene, ray_d, swl, beta, p_b, specular, prev_p, prev_ns, l, miss):
    """Escaped rays picking up the infinite lights, MIS-weighted."""

    def pmf(i):
        return light_pmf(scene, torch.full(p_b.shape, i, dtype=torch.int32, device=p_b.device))

    for i in scene.uniform_infinite_indices:
        le = dense_sample(scene.lights.spectrum[i], swl.lam) * scene.lights.scale[i]
        pdf_l = pmf(i) * UNIFORM_SPHERE_PDF
        w = torch.where(specular, 1.0, power_heuristic(1.0, p_b, 1.0, pdf_l))
        l = l + torch.where(miss[..., None], beta * w[..., None] * le, 0.0)
    for i in scene.image_infinite_indices:
        le = env_le(scene.env, ray_d, swl)
        pdf_l = pmf(i) * env_pdf_li(scene.env, ray_d)
        w = torch.where(specular, 1.0, power_heuristic(1.0, p_b, 1.0, pdf_l))
        l = l + torch.where(miss[..., None], beta * w[..., None] * le, 0.0)
    return l


def sample_ld_prepare(scene: Scene, si, frame, swl, sampler, s_state, bsdf_ctx):
    """Next-event estimation with light-side MIS and deferred visibility.

    Returns (unshadowed contribution (..., 4), shadow (o, d, t_max,
    usable), new sampler state); the caller traces the shadow segment in
    the next merged traversal."""
    uc, s_state = sampler.get_1d(s_state)
    u2, s_state = sampler.get_2d(s_state)
    light_idx, pmf, _ = sample_light(scene, uc)
    ls = lt.sample_li(
        scene.lights, light_idx, si.p, si.ns, u2, swl, scene.spheres, scene.light_kinds,
        tri_sampler=_tri_sampler(scene), env=scene.env, patch_sampler=_patch_sampler(scene),
    )
    f = bsdf_f(
        scene.materials, scene.material_kinds, si.material_id, frame, si.ns,
        si.wo, ls.wi, swl, **bsdf_ctx,
    ) * abs_dot(ls.wi, si.ns)[..., None]
    usable = ls.valid & (ls.pdf > 0.0) & ~ss_is_black(f)
    p_l = pmf * ls.pdf
    p_b = bsdf_pdf(
        scene.materials, scene.material_kinds, si.material_id, frame, si.ns,
        si.wo, ls.wi, swl, **bsdf_ctx,
    )
    w_l = torch.where(
        ls.is_delta, 1.0, power_heuristic(1.0, p_l, 1.0, p_b)
    ) / torch.clamp(p_l, min=1e-20)
    contrib = torch.where(usable[..., None], f * ls.l * w_l[..., None], 0.0)

    d = ls.p_light - si.p
    sh_o = offset_ray_origin(si.p, si.n, d)
    target = torch.where(
        torch.any(ls.n_light != 0.0, dim=-1, keepdim=True),
        offset_ray_origin(ls.p_light, ls.n_light, -d),
        ls.p_light,
    )
    sh_d = target - sh_o
    sh_tmax = torch.full(usable.shape, 1.0 - 1e-3, dtype=torch.float32, device=usable.device)
    return contrib, (sh_o, sh_d, sh_tmax, usable), s_state


def sample_ld_medium_prepare(scene: Scene, p_m, wo, g, swl, sampler, s_state):
    """Next-event estimation from a medium scatter vertex: the HG phase
    value is both f and the scattering pdf of the MIS weight, visibility
    deferred as in sample_ld_prepare.  The caller applies the shadow
    segment's transmittance."""
    uc, s_state = sampler.get_1d(s_state)
    u2, s_state = sampler.get_2d(s_state)
    light_idx, pmf, _ = sample_light(scene, uc)
    ls = lt.sample_li(
        scene.lights, light_idx, p_m, torch.zeros_like(p_m), u2, swl, scene.spheres,
        scene.light_kinds, tri_sampler=_tri_sampler(scene), env=scene.env,
        patch_sampler=_patch_sampler(scene),
    )
    ph = henyey_greenstein(dot(wo, ls.wi), g)
    usable = ls.valid & (ls.pdf > 0.0) & (ph > 0.0)
    p_l = pmf * ls.pdf
    w_l = torch.where(
        ls.is_delta, 1.0, power_heuristic(1.0, p_l, 1.0, ph)
    ) / torch.clamp(p_l, min=1e-20)
    contrib = torch.where(usable[..., None], ph[..., None] * ls.l * w_l[..., None], 0.0)
    # A medium vertex has no surface to offset from.
    sh_d = ls.p_light - p_m
    sh_tmax = torch.full(usable.shape, 1.0 - 1e-3, dtype=torch.float32, device=usable.device)
    return contrib, (p_m, sh_d, sh_tmax, usable), s_state


def _medium_segment(scene, sampler, swl, s_state, mid, si, alive, beta):
    """Homogeneous-medium distance sampling over a traced segment: channel
    0 (the hero wavelength) samples the free-flight distance, the other
    channels carry the spectral transmittance ratio.  A lane that
    scatters gets beta * Tr * sigma_s / pdf, one that reaches the hit (or
    escapes) beta * Tr / P(survive); a lane in vacuum keeps beta.  An
    escape inside a medium sees t = 1e20, so its transmittance is 0 and
    its beta 0.

    mid: (N,) int32 per-lane medium ids (-1: vacuum).  Returns
    (s_state, beta, scattered, (sig_t, g_m, t_m))."""
    u_m, s_state = sampler.get_1d(s_state)
    sig_a, sig_s, g_m = medium_sigma(scene.media, mid, swl.lam)
    sig_t = sig_a + sig_s
    sig0 = sig_t[..., 0]
    t_seg = torch.where(si.valid, si.t, INF)
    t_m = -torch.log1p(-torch.clamp(u_m, max=1.0 - 1e-7)) / torch.clamp(sig0, min=1e-20)
    scattered = alive & (sig0 > 0.0) & (t_m < t_seg)
    survive = alive & (sig0 > 0.0) & ~scattered
    tr_m = torch.exp(-sig_t * t_m[..., None])
    pdf_m = torch.clamp(sig0 * torch.exp(-sig0 * t_m), min=1e-30)
    t_far = torch.clamp(t_seg, max=1e20)
    tr_s = torch.exp(-sig_t * t_far[..., None])
    pdf_s = torch.clamp(torch.exp(-sig0 * t_far), min=1e-30)
    beta = torch.where(
        scattered[..., None],
        beta * tr_m * sig_s / pdf_m[..., None],
        torch.where(survive[..., None], beta * tr_s / pdf_s[..., None], beta),
    )
    return s_state, beta, scattered, (sig_t, g_m, t_m)


# Interface crossings a shadow segment may make: round 0 is the merged
# trace's shadow half, rounds 1-3 trace one closest hit each (always, so
# each iteration launches the traversal a fixed number of times).
SHADOW_MARCH_ROUNDS = 4


def shadow_march_interfaces(scene, swl, sh_o, sh_d, sh_tmax, sh_live, start_med, si0=None):
    """Visibility and transmittance of shadow segments in a scene with
    interface media.  A material-less hit on a declared interface crosses
    it (the medium switches for the next sub-segment); a hit on a shape
    with a material occludes; a segment still crossing after
    SHADOW_MARCH_ROUNDS rounds counts as occluded.

    sh_d is the whole segment (t in [0, sh_tmax]); start_med the medium
    at the shadow origin; si0 the closest hit of round 0 when the caller
    traced it.  Returns (visible, tr): tr is the (N, 4) transmittance
    along the segment."""
    seg_len = length(sh_d)
    o = sh_o
    t_hi = torch.where(sh_live, sh_tmax, -INF)
    cur = start_med
    tr = torch.ones(sh_d.shape[:-1] + (4,), dtype=torch.float32, device=sh_d.device)
    pending = sh_live
    occluded = torch.zeros_like(sh_live)
    for r in range(SHADOW_MARCH_ROUNDS):
        if r == 0 and si0 is not None:
            si = si0
        else:
            si = scene_intersect(scene, o, sh_d, torch.where(pending, t_hi, -INF))
        hit = pending & si.valid
        t_seg = torch.where(hit, si.t, torch.clamp(t_hi, min=0.0))
        sig_a, sig_s, _ = medium_sigma(scene.media, cur, swl.lam)
        sig_t = sig_a + sig_s
        tr = torch.where(pending[..., None], tr * torch.exp(-sig_t * (t_seg * seg_len)[..., None]),
                         tr)
        is_iface = hit & (si.material_id < 0)
        occluded = occluded | (hit & ~is_iface)
        # A declared boundary switches the medium; an undeclared
        # material-less shape is passed without a change.
        declared = si.med_in > -2
        entering = dot(sh_d, si.n) < 0.0
        new_med = torch.where(entering, si.med_in, si.med_out)
        new_med = torch.where(declared, torch.clamp(new_med, min=-1), cur)
        cur = torch.where(is_iface, new_med, cur)
        o = torch.where(is_iface[..., None], offset_ray_origin(si.p, si.n, sh_d), o)
        t_hi = torch.where(is_iface, t_hi - t_seg, t_hi)
        pending = is_iface
    occluded = occluded | pending
    return sh_live & ~occluded, tr


def _has_proportional_pdfs(scene) -> bool:
    """Census: only the stochastic layered coats return proportional pdfs
    from their sample; without them the MIS re-evaluation is skipped."""
    return any(k in (mtl.COATED_DIFFUSE, mtl.COATED_CONDUCTOR) for k in scene.material_kinds)


def _prepare_hit(scene, si, ray_d, pixel_spread: float = 0.0):
    """Per-hit preparation for a scene with textures: the texture
    footprints from the pixel spread, then normal and bump mapping."""
    if scene.textures is None:
        return si
    if pixel_spread > 0.0:
        si = si.with_camera_differentials(ray_d, pixel_spread)
    return apply_normal_bump(scene, si)


def _resolve_mix(scene, si, sampler, s_state):
    """Resolve mix materials stochastically at the hit; draws one sampler
    dimension only when the scene has a mix material.  A textured amount
    is evaluated at the hit."""
    if mtl.MIX not in scene.material_kinds:
        return si, s_state
    u_mix, s_state = sampler.get_1d(s_state)
    amt = None
    if scene.materials.has_textured_mix and scene.textures is not None:
        mats = scene.materials
        tid = small_gather(mats.tex_mix_amount, si.material_id)
        val = eval_float_texture(scene.textures, torch.clamp(tid, min=0), si)
        amt = torch.where(tid >= 0, val, small_gather(mats.mix_amount, si.material_id))
    mat_id = mtl.resolve_mix(scene.materials, scene.material_kinds, si.material_id, u_mix,
                             amt_override=amt)
    return dataclasses.replace(si, material_id=mat_id), s_state


def _apply_dispersion(scene, si, alive, beta, terminated):
    """Dispersion: a lane whose (mix-resolved) material is a dielectric
    with a spectral eta collapses to the hero wavelength before its BSDF
    is built.  As in the reference, this reweights the throughput on the
    first dispersive hit, beta <- beta * (N, 0, 0, 0), and leaves the
    wavelength pdf alone: the film keeps dividing by the original pdf, so
    contributions after the hit are the single-wavelength estimate (N on
    the hero cancels the 1/N spectral average) and earlier ones stay.
    Returns (beta, terminated)."""
    mats = scene.materials
    if not mats.has_dispersion:
        return beta, terminated
    mid = torch.clamp(si.material_id, min=0).long()
    disp = alive & si.valid & (si.material_id >= 0) & mats.dispersive[mid]
    newly = disp & ~terminated
    hero_only = torch.tensor(
        [float(N_SPECTRUM_SAMPLES)] + [0.0] * (N_SPECTRUM_SAMPLES - 1), device=beta.device
    )
    beta = torch.where(newly[..., None], beta * hero_only, beta)
    return beta, terminated | newly


def _with_rng_key(scene, bsdf_ctx, s_state):
    """Attach a per-lane counter-RNG key for the stochastic (layered)
    BxDFs, keyed by the full sampler state so that every (pixel, sample,
    bounce) gets a stream of its own."""
    if not _has_proportional_pdfs(scene):
        return bsdf_ctx
    return dict(
        bsdf_ctx,
        rng_key=srng.hash_combine(s_state.pixel_hash, s_state.sample_index, s_state.dim),
    )


def _bsdf_ctx(scene, si, swl):
    """Per-hit BSDF context: the scene's dense spectra table and the
    texture-resolved material parameters."""
    tex = None
    if scene.textures is not None:
        tex = evaluate_material_textures(scene.textures, scene.materials, si, swl)
    return {"spectra_table": scene.spectra_table, "tex": tex}
