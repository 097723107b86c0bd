"""Path-tracing estimators over masked lanes (port of
``shimmer_tpu/integrators/path.py``).

``li_path`` is the masked megakernel: every lane advances one bounce per
step of a Python loop over ``max_depth`` bounces, dead lanes masked, with
next-event estimation, MIS and Russian roulette.  Each call traces one
camera trace and then one merged 2N-lane trace per bounce: the extension
rays (closest hit) and the NEE shadow rays (any hit), so a triangle scene
launches the traversal kernel ``1 + max_depth`` times per call whatever
the lanes do.  ``li_simple_path`` (NEE without MIS, or uniform sampling)
and ``li_random_walk`` (uniform-sphere walk) are the validation
estimators: one closest-hit trace per depth, and simplepath's shadow test
is an any-hit trace of its own.  All three draw the sampler's dimensions
in the reference's order, so a sample sees the same numbers in both
packages.

The helpers are shared with the wavefront loop (``integrators/
wavefront.py``).  For a scene with textures, the hit-preparation hook sets
the texture footprints from the camera's pixel spread and applies normal
and bump maps; the BSDF context carries the per-lane texture-driven
parameters.  A scene without textures skips both, as the footprints feed
textures only.  For a scene with media: the free-flight sampling over a
traced segment (``_medium_segment``), next-event estimation from a medium
vertex (``sample_ld_medium_prepare``) and the shadow march through
material-less interface shapes (``shadow_march_interfaces``).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from benchmark.reference.frozen.lights import lights as lt
from benchmark.reference.frozen.lights.env import env_le, env_pdf_li
from benchmark.reference.frozen.materials import material as mtl
from benchmark.reference.frozen.materials.material import bsdf_f, bsdf_pdf, bsdf_sample
from benchmark.reference.frozen.ops import rng as srng
from benchmark.reference.frozen.ops.math import small_gather
from benchmark.reference.frozen.ops.ray import offset_ray_origin
from benchmark.reference.frozen.ops.sampling import (
    UNIFORM_SPHERE_PDF,
    power_heuristic,
    sample_uniform_sphere,
)
from benchmark.reference.frozen.materials.scattering import henyey_greenstein, sample_henyey_greenstein
from benchmark.reference.frozen.media import medium_sigma
from benchmark.reference.frozen.ops.vecmath import abs_dot, dot, length, normalize
from benchmark.reference.frozen.scene import (
    Scene,
    light_pmf,
    sample_light,
    scene_intersect,
    scene_intersect_merged,
    scene_intersect_merged_full,
    scene_intersect_predicate,
)
from benchmark.reference.frozen.shapes.bilinear import bilinear_light_pdf, bilinear_light_sample
from benchmark.reference.frozen.shapes.triangle import triangle_light_pdf, triangle_light_sample
from benchmark.reference.frozen.spectra.sampled import N_SPECTRUM_SAMPLES, ss_is_black
from benchmark.reference.frozen.spectra.spectrum import dense_sample
from benchmark.reference.frozen.textures.normal_bump import apply_normal_bump
from benchmark.reference.frozen.textures.textures import eval_float_texture, evaluate_material_textures

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


def _unoccluded(scene, p, n, p_light, n_light=None):
    """Shadow test between two offset points: one any-hit trace."""
    d = p_light - p
    o = offset_ray_origin(p, n, d)
    target = p_light if n_light is None else offset_ray_origin(p_light, n_light, -d)
    t_max = torch.full(p.shape[:-1], 1.0 - 1e-3, dtype=torch.float32, device=p.device)
    return ~scene_intersect_predicate(scene, o, target - o, t_max)


def sample_ld(scene: Scene, si, frame, swl, sampler, s_state, bsdf_ctx):
    """NEE with its visibility traced at once (an any-hit trace of its
    own): the contribution where unoccluded, and the sampler state."""
    contrib, (sh_o, sh_d, sh_tmax, usable), s_state = sample_ld_prepare(
        scene, si, frame, swl, sampler, s_state, bsdf_ctx
    )
    occ = scene_intersect_predicate(scene, sh_o, sh_d, sh_tmax)
    return torch.where((usable & ~occ)[..., None], contrib, 0.0), s_state


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


def _with_regularize(bsdf_ctx, mask):
    """The BSDF context with the lanes of ``mask`` (past their first
    non-specular bounce) flagged for roughening near-specular lobes."""
    return dict(bsdf_ctx, tex=dict(bsdf_ctx.get("tex") or {}, regularize=mask))


def _env_eval(scene):
    if not scene.image_infinite_indices:
        return None
    return lambda i, d, swl: env_le(scene.env, d, swl)


def _emit(scene, ray_d, swl, beta, p_b, specular, prev_p, prev_ns, l, alive, si,
          scattered=None):
    """MIS-weighted emission of the current hit or escape.  ``scattered``
    lanes stopped at a medium vertex short of the surface: they see no
    emission from this segment and stay alive whether it hit or not.
    Returns (l, alive)."""
    reach = alive if scattered is None else alive & ~scattered
    miss = reach & ~si.valid
    l = _infinite_le_with_mis(scene, ray_d, swl, beta, p_b, specular, prev_p, prev_ns, l, miss)
    l = _area_le_with_mis(scene, si, swl, beta, p_b, specular, prev_p, prev_ns, l, reach)
    return l, alive & (si.valid if scattered is None else si.valid | scattered)


def _count(mask):
    return torch.sum(mask.to(torch.int64))


def li_path(scene: Scene, ray, swl, sampler, s_state, max_depth: int = 5,
            regularize: bool = False, return_stats: bool = False, pixel_spread: float = 0.0,
            alive_mask=None, remat: bool = False):
    """The masked megakernel: NEE + MIS power heuristic + Russian roulette
    over (N,) lanes, ``max_depth`` bounces.

    Returns the (N, 4) radiance estimate, and with ``return_stats`` a dict
    whose ``rays`` is the count of traced rays (camera, extension and
    shadow lanes that were live).  ``alive_mask`` marks the lanes that
    carry work; the others trace with t_max = -inf and cost nothing.
    ``regularize`` roughens near-specular lobes past a path's first
    non-specular bounce.  Per bounce the extension and the shadow rays go
    through one merged trace; with interface media the shadow half gets
    closest hits and the shadow march crosses material-less boundaries.

    ``remat`` shapes reverse-mode AD through the bounces.  ``False`` and
    ``True`` run the same unrolled bounces (the reference's ``True`` is a
    scan over one traced bounce, which eager torch has no use for), and
    autograd keeps every bounce's intermediates.  ``"full"`` wraps each
    bounce in ``torch.utils.checkpoint``: the backward keeps only the
    per-bounce carry and recomputes the bounce, so activation memory no
    longer grows with the bounces' glue.  The forward is the same in
    every form, and Russian roulette stays off on bounce 0."""
    if remat not in (False, True, "full"):
        raise ValueError(f"li_path: remat must be False, True or 'full', not {remat!r}")
    dev = ray.o.device
    n = ray.o.shape[:-1]
    flat = n[0] if n else 1
    l = torch.zeros(n + (4,), dtype=torch.float32, device=dev)
    beta = torch.ones(n + (4,), dtype=torch.float32, device=dev)
    alive = (torch.ones(n, dtype=torch.bool, device=dev) if alive_mask is None
             else torch.as_tensor(alive_mask, device=dev).to(torch.bool))
    specular = torch.ones(n, dtype=torch.bool, device=dev)
    p_b = torch.ones(n, dtype=torch.float32, device=dev)
    eta_scale = torch.ones(n, dtype=torch.float32, device=dev)
    prev_p = ray.o
    prev_ns = torch.zeros(n + (3,), dtype=torch.float32, device=dev)
    any_ns = torch.zeros(n, dtype=torch.bool, device=dev)
    lam_term = torch.zeros(n, dtype=torch.bool, device=dev)
    ray_o, ray_d = ray.o, ray.d

    # The camera trace; a dead lane gets t_max = -inf and no traversal work.
    rays = _count(alive)
    si = scene_intersect(scene, ray_o, ray_d, torch.where(alive, INF, -INF))

    # The medium branches run only for a scene with a camera medium or
    # interface media; with interface media each lane carries its medium.
    iface_med = scene.media is not None and scene.has_interface_media
    has_med = scene.media is not None and (scene.camera_medium >= 0 or iface_med)
    cur_med = torch.full(n, scene.camera_medium, dtype=torch.int32, device=dev)

    def bounce(depth, carry):
        (l, beta, alive, specular, p_b, eta_scale, prev_p, prev_ns, any_ns, lam_term, ray_o,
         ray_d, si, s_state, rays, cur_med) = carry
        scattered = None
        if has_med:
            # Free-flight sampling over the segment just traced.
            s_state, beta, scattered, (sig_t, g_m, t_m) = _medium_segment(
                scene, sampler, swl, s_state, cur_med, si, alive, beta)
            seg_o, seg_d = ray_o, ray_d
        l, alive = _emit(scene, ray_d, swl, beta, p_b, specular, prev_p, prev_ns, l, alive, si,
                         scattered)
        # Lanes that shade a surface; a scattered lane shades its medium
        # vertex instead, even where the segment hit a surface beyond it.
        surf = alive & si.valid & ~scattered if has_med else alive

        si = _prepare_hit(scene, si, ray_d, pixel_spread)
        si, s_state = _resolve_mix(scene, si, sampler, s_state)
        beta, lam_term = _apply_dispersion(scene, si, surf, beta, lam_term)
        frame = si.shading_frame()
        bsdf_ctx = _with_rng_key(scene, _bsdf_ctx(scene, si, swl), s_state)
        if regularize:
            bsdf_ctx = _with_regularize(bsdf_ctx, any_ns)

        # NEE: a light sample and its deferred shadow segment.
        beta_nee = beta
        ld, (sh_o, sh_d, sh_tmax, sh_usable), s_state = sample_ld_prepare(
            scene, si, frame, swl, sampler, s_state, bsdf_ctx)
        sh_live = surf & sh_usable
        # The path state before the surface, for pass-through lanes.
        p_b_pre, spec_pre, prev_p_pre, prev_ns_pre = p_b, specular, prev_p, prev_ns

        # BSDF sampling.
        u2, s_state = sampler.get_2d(s_state)
        uc, s_state = sampler.get_1d(s_state)
        bs = bsdf_sample(scene.materials, scene.material_kinds, si.material_id, frame, si.ns,
                         si.wo, u2, uc, swl, **bsdf_ctx)
        cos_f = abs_dot(bs.wi, si.ns)
        step = torch.where((bs.pdf > 0.0)[..., None],
                           bs.f * (cos_f / torch.clamp(bs.pdf, min=1e-20))[..., None], 0.0)
        beta = torch.where(surf[..., None], beta * step, beta)
        p_b_new = bs.pdf
        if _has_proportional_pdfs(scene):
            # A layered coat's sample pdf is proportional only: MIS at the
            # next hit needs the (estimated) true pdf.
            p_b_new = torch.where(
                bs.pdf_is_proportional,
                bsdf_pdf(scene.materials, scene.material_kinds, si.material_id, frame, si.ns,
                         si.wo, bs.wi, swl, **bsdf_ctx),
                bs.pdf,
            )
        surf3 = surf[..., None]
        p_b = torch.where(surf, p_b_new, p_b)
        specular = torch.where(surf, bs.is_specular(), specular)
        any_ns = any_ns | (surf & ~bs.is_specular())
        eta_scale = torch.where(surf, eta_scale * bs.eta * bs.eta, eta_scale)
        prev_p = torch.where(surf3, si.p, prev_p)
        prev_ns = torch.where(surf3, si.ns, prev_ns)
        ray_o = torch.where(surf3, offset_ray_origin(si.p, si.n, bs.wi), ray_o)
        ray_d = torch.where(surf3, bs.wi, ray_d)
        alive_surf = surf & bs.valid & ~ss_is_black(beta)

        if has_med:
            # A medium vertex: NEE through the phase function, then an HG
            # continuation.
            p_med = seg_o + t_m[..., None] * seg_d
            wo_m = -seg_d
            ld_m, (sh_o_m, sh_d_m, sh_tmax_m, usable_m), s_state = sample_ld_medium_prepare(
                scene, p_med, wo_m, g_m, swl, sampler, s_state)
            u2_m, s_state = sampler.get_2d(s_state)
            wi_m, pdf_ph = sample_henyey_greenstein(wo_m, g_m, u2_m)
            scat3 = scattered[..., None]
            ld = torch.where(scat3, ld_m, ld)
            sh_o = torch.where(scat3, sh_o_m, sh_o)
            sh_d = torch.where(scat3, sh_d_m, sh_d)
            sh_tmax = torch.where(scattered, sh_tmax_m, sh_tmax)
            sh_live = sh_live | (scattered & usable_m)
            if not iface_med:
                # Exact for one exterior medium; interface scenes take the
                # march's transmittance instead.
                ld = ld * torch.exp(-sig_t * length(sh_d)[..., None])
            p_b = torch.where(scattered, pdf_ph, p_b)
            specular = torch.where(scattered, False, specular)
            any_ns = any_ns | scattered
            prev_p = torch.where(scat3, p_med, prev_p)
            prev_ns = torch.where(scat3, 0.0, prev_ns)
            ray_o = torch.where(scat3, p_med, ray_o)
            ray_d = torch.where(scat3, wi_m, ray_d)
            alive = alive_surf | (scattered & (pdf_ph > 0.0) & ~ss_is_black(beta))
        else:
            alive = alive_surf

        if iface_med:
            # Interface crossing: a material-less shape passes the ray
            # straight through; a declared boundary switches the medium.
            declared = si.med_in > -2
            pass_thru = surf & (si.material_id < 0)
            dirn = -si.wo
            pt3 = pass_thru[..., None]
            ray_o = torch.where(pt3, offset_ray_origin(si.p, si.n, dirn), ray_o)
            ray_d = torch.where(pt3, dirn, ray_d)
            beta = torch.where(pt3, beta_nee, beta)
            p_b = torch.where(pass_thru, p_b_pre, p_b)
            specular = torch.where(pass_thru, spec_pre, specular)
            prev_p = torch.where(pt3, prev_p_pre, prev_p)
            prev_ns = torch.where(pt3, prev_ns_pre, prev_ns)
            sh_live = sh_live & ~pass_thru
            alive = alive | pass_thru
            # The medium at the shadow origin: a surface on a declared
            # boundary starts on the side the shadow ray leaves by; other
            # vertices stay in the segment's medium.
            sh_side = torch.where(dot(sh_d, si.n) < 0.0, si.med_in, si.med_out)
            sh_med = torch.where(surf & declared, torch.clamp(sh_side, min=-1), cur_med)
            crossed = surf & declared & alive
            entering = dot(ray_d, si.n) < 0.0
            new_med = torch.where(entering, si.med_in, si.med_out)
            cur_med = torch.where(crossed, torch.clamp(new_med, min=-1), cur_med)
        rays = rays + _count(sh_live)

        # Russian roulette on beta * eta_scale past the first bounce.
        u_rr, s_state = sampler.get_1d(s_state)
        if depth > 0:
            rr_beta = torch.max(beta * eta_scale[..., None], dim=-1).values
            # Detached: the survival probability is part of the sampling
            # measure, not the integrand.
            q = torch.clamp(1.0 - rr_beta, min=0.0).detach()
            kill = alive & (u_rr < q)
            beta = torch.where(alive[..., None], beta / torch.clamp(1.0 - q, min=1e-6)[..., None],
                               beta)
            alive = alive & ~kill

        # One merged trace: extension (closest hit) + shadow (any hit).
        rays = rays + _count(alive)
        mo = torch.cat([ray_o, sh_o], dim=0)
        md = torch.cat([ray_d, sh_d], dim=0)
        mt = torch.cat([torch.where(alive, INF, -INF), torch.where(sh_live, sh_tmax, -INF)], dim=0)
        if iface_med:
            si, si_sh = scene_intersect_merged_full(scene, mo, md, mt, flat)
            visible, tr_sh = shadow_march_interfaces(scene, swl, sh_o, sh_d, sh_tmax, sh_live,
                                                     sh_med, si0=si_sh)
            l = l + torch.where(visible[..., None], beta_nee * ld * tr_sh, 0.0)
        else:
            si, occluded = scene_intersect_merged(scene, mo, md, mt, flat)
            l = l + torch.where((sh_live & ~occluded)[..., None], beta_nee * ld, 0.0)
        return (l, beta, alive, specular, p_b, eta_scale, prev_p, prev_ns, any_ns, lam_term,
                ray_o, ray_d, si, s_state, rays, cur_med)

    carry = (l, beta, alive, specular, p_b, eta_scale, prev_p, prev_ns, any_ns, lam_term, ray_o,
             ray_d, si, s_state, rays, cur_med)
    for depth in range(max_depth):
        if remat == "full":
            # The recompute reruns the whole bounce, its traversal included
            # (no early stop), so a block launches the kernel
            # 1 + 2 * max_depth times over forward and backward.  Its
            # outputs (the ray count among them) are dropped: only the
            # forward's count is returned.
            with set_checkpoint_early_stop(False):
                carry = checkpoint(bounce, depth, carry, use_reentrant=False,
                                   preserve_rng_state=False)
        else:
            carry = bounce(depth, carry)
    (l, beta, alive, specular, p_b, eta_scale, prev_p, prev_ns, any_ns, lam_term, ray_o, ray_d,
     si, s_state, rays, cur_med) = carry

    # Emission of the final segment, which gets the same free-flight
    # sampling as every segment before it.
    scattered = None
    if has_med:
        s_state, beta, scattered, _ = _medium_segment(scene, sampler, swl, s_state, cur_med, si,
                                                      alive, beta)
    l, _ = _emit(scene, ray_d, swl, beta, p_b, specular, prev_p, prev_ns, l, alive, si, scattered)
    if return_stats:
        return l, {"rays": rays.to(torch.float32)}
    return l


def li_simple_path(scene: Scene, ray, swl, sampler, s_state, max_depth: int = 5,
                   sample_lights: bool = True, sample_bsdf: bool = True,
                   pixel_spread: float = 0.0):
    """Validation estimator: NEE without MIS (its visibility traced at
    once), BSDF sampling or, without it, uniform sphere sampling flipped
    into the hemisphere of wo.  Emission counts on escapes and emissive
    hits only after a specular bounce when NEE is on."""
    dev = ray.o.device
    n = ray.o.shape[:-1]
    l = torch.zeros(n + (4,), dtype=torch.float32, device=dev)
    beta = torch.ones(n + (4,), dtype=torch.float32, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    specular = torch.ones(n, dtype=torch.bool, device=dev)
    lam_term = torch.zeros(n, dtype=torch.bool, device=dev)
    ray_o, ray_d = ray.o, ray.d
    t_inf = torch.full(n, INF, dtype=torch.float32, device=dev)

    for depth in range(max_depth + 1):
        si = scene_intersect(scene, ray_o, ray_d, t_inf)
        miss = alive & ~si.valid
        take = miss & specular if sample_lights else miss
        le_inf = lt.infinite_le(scene.lights, ray_d, swl, scene.uniform_infinite_indices,
                                scene.image_infinite_indices, env_eval=_env_eval(scene))
        l = l + torch.where(take[..., None], beta * le_inf, 0.0)

        has_light = alive & si.valid & (si.area_light_id >= 0)
        take_area = has_light & specular if sample_lights else has_light
        lid = torch.clamp(si.area_light_id, min=0)
        le = lt.area_light_l(scene.lights, lid, si.n, si.wo, swl)
        l = l + torch.where(take_area[..., None], beta * le, 0.0)

        alive = alive & si.valid
        if depth == max_depth:
            break
        si = _prepare_hit(scene, si, ray_d, pixel_spread)
        si, s_state = _resolve_mix(scene, si, sampler, s_state)
        beta, lam_term = _apply_dispersion(scene, si, alive, beta, lam_term)
        frame = si.shading_frame()
        bsdf_ctx = _with_rng_key(scene, _bsdf_ctx(scene, si, swl), s_state)

        if sample_lights:
            uc, s_state = sampler.get_1d(s_state)
            u2, s_state = sampler.get_2d(s_state)
            light_idx, pmf, _ = sample_light(scene, uc)
            ls = lt.sample_li(
                scene.lights, light_idx, si.p, si.ns, u2, swl, scene.spheres, scene.light_kinds,
                tri_sampler=_tri_sampler(scene), env=scene.env,
                patch_sampler=_patch_sampler(scene),
            )
            f = bsdf_f(scene.materials, scene.material_kinds, si.material_id, frame, si.ns,
                       si.wo, ls.wi, swl, **bsdf_ctx) * abs_dot(ls.wi, si.ns)[..., None]
            visible = _unoccluded(scene, si.p, si.n, ls.p_light, ls.n_light)
            ok = alive & ls.valid & (ls.pdf > 0.0) & visible & ~ss_is_black(f)
            contrib = f * ls.l / (pmf * ls.pdf)[..., None]
            l = l + torch.where(ok[..., None], beta * contrib, 0.0)

        if sample_bsdf:
            u2, s_state = sampler.get_2d(s_state)
            uc, s_state = sampler.get_1d(s_state)
            bs = bsdf_sample(scene.materials, scene.material_kinds, si.material_id, frame, si.ns,
                             si.wo, u2, uc, swl, **bsdf_ctx)
            step = torch.where(
                (bs.pdf > 0.0)[..., None],
                bs.f * (abs_dot(bs.wi, si.ns) / torch.clamp(bs.pdf, min=1e-20))[..., None],
                0.0,
            )
            beta = torch.where(alive[..., None], beta * step, beta)
            specular = torch.where(alive, bs.is_specular(), specular)
            wi = bs.wi
            valid_step = bs.valid
        else:
            u2, s_state = sampler.get_2d(s_state)
            wi = sample_uniform_sphere(u2)
            flip = dot(wi, si.ns) * dot(si.wo, si.ns) < 0.0
            wi = torch.where(flip[..., None], -wi, wi)
            f = bsdf_f(scene.materials, scene.material_kinds, si.material_id, frame, si.ns,
                       si.wo, wi, swl, **bsdf_ctx)
            pdf = 1.0 / (2.0 * math.pi)
            beta = torch.where(alive[..., None], beta * f * (abs_dot(wi, si.ns) / pdf)[..., None],
                               beta)
            specular = torch.where(alive, False, specular)
            valid_step = torch.ones(n, dtype=torch.bool, device=dev)

        ray_o = torch.where(alive[..., None], offset_ray_origin(si.p, si.n, wi), ray_o)
        ray_d = torch.where(alive[..., None], wi, ray_d)
        alive = alive & valid_step & ~ss_is_black(beta)
    return l


def li_random_walk(scene: Scene, ray, swl, sampler, s_state, max_depth: int = 5,
                   pixel_spread: float = 0.0):
    """Ground-truth sanity estimator: a uniform-sphere random walk that
    collects emission where it lands."""
    dev = ray.o.device
    n = ray.o.shape[:-1]
    l = torch.zeros(n + (4,), dtype=torch.float32, device=dev)
    beta = torch.ones(n + (4,), dtype=torch.float32, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    ray_o, ray_d = ray.o, ray.d
    t_inf = torch.full(n, INF, dtype=torch.float32, device=dev)
    for depth in range(max_depth + 1):
        si = scene_intersect(scene, ray_o, ray_d, t_inf)
        miss = alive & ~si.valid
        le_inf = lt.infinite_le(scene.lights, ray_d, swl, scene.uniform_infinite_indices,
                                scene.image_infinite_indices, env_eval=_env_eval(scene))
        l = l + torch.where(miss[..., None], beta * le_inf, 0.0)
        has_light = alive & si.valid & (si.area_light_id >= 0)
        lid = torch.clamp(si.area_light_id, min=0)
        le = lt.area_light_l(scene.lights, lid, si.n, si.wo, swl)
        l = l + torch.where(has_light[..., None], beta * le, 0.0)
        alive = alive & si.valid
        if depth == max_depth:
            break
        si = _prepare_hit(scene, si, ray_d, pixel_spread)
        frame = si.shading_frame()
        bsdf_ctx = _bsdf_ctx(scene, si, swl)
        u2, s_state = sampler.get_2d(s_state)
        wp = sample_uniform_sphere(u2)
        f = bsdf_f(scene.materials, scene.material_kinds, si.material_id, frame, si.ns, si.wo,
                   wp, swl, **bsdf_ctx)
        beta = torch.where(
            alive[..., None], beta * f * (abs_dot(wp, si.ns) / UNIFORM_SPHERE_PDF)[..., None], beta
        )
        ray_o = torch.where(alive[..., None], offset_ray_origin(si.p, si.n, wp), ray_o)
        ray_d = torch.where(alive[..., None], wp, ray_d)
        alive = alive & ~ss_is_black(beta)
    return l
