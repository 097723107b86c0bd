"""Path-integrator helpers that the wavefront loop uses (port of the
helpers ``shimmer_tpu/integrators/wavefront.py`` imports from
``shimmer_tpu/integrators/path.py``).

The hit-preparation, mix-material, dispersion and RNG-keyed-BSDF hooks are
reduced to their no-op form: the slice's scenes have none of them, and a scene that
does is refused when its tables are built (materials/material.py).
"""

from __future__ import annotations

import torch

from shimmer_tpu_torch.lights import lights as lt
from shimmer_tpu_torch.materials.material import bsdf_f, bsdf_pdf
from shimmer_tpu_torch.ops.ray import offset_ray_origin
from shimmer_tpu_torch.ops.sampling import UNIFORM_SPHERE_PDF, power_heuristic
from shimmer_tpu_torch.ops.vecmath import abs_dot, normalize
from shimmer_tpu_torch.scene import Scene, light_pmf, sample_light
from shimmer_tpu_torch.shapes.triangle import triangle_light_pdf, triangle_light_sample
from shimmer_tpu_torch.spectra.sampled import ss_is_black
from shimmer_tpu_torch.spectra.spectrum import dense_sample

INF = float("inf")


def _tri_sampler(scene):
    return lambda sidx, ref_p, ref_ns, u: triangle_light_sample(
        scene.triangles, sidx, ref_p, ref_ns, u
    )


def _tri_pdf(scene):
    return lambda sidx, ref_p, ref_ns, wi, si_p, si_n: triangle_light_pdf(
        scene.triangles, sidx, ref_p, ref_ns, wi, si_p, si_n
    )


def _area_le_with_mis(scene, si, swl, beta, p_b, specular, prev_p, prev_ns, l, alive):
    """Emission from an emissive hit, MIS-weighted against NEE."""
    has_light = alive & si.valid & (si.area_light_id >= 0)
    lid = torch.clamp(si.area_light_id, min=0)
    le = lt.area_light_l(scene.lights, lid, si.n, si.wo, swl)
    pdf_l = light_pmf(scene, lid) * lt.pdf_li(
        scene.lights, lid, prev_p, prev_ns, normalize(si.p - prev_p), si.p, si.n,
        scene.light_kinds, tri_pdf=_tri_pdf(scene),
    )
    w = torch.where(specular, 1.0, power_heuristic(1.0, p_b, 1.0, pdf_l))
    return l + torch.where(has_light[..., None], beta * w[..., None] * le, 0.0)


def _infinite_le_with_mis(scene, ray_d, swl, beta, p_b, specular, prev_p, prev_ns, l, miss):
    """Escaped rays picking up the uniform infinite lights."""
    for i in scene.uniform_infinite_indices:
        le = dense_sample(scene.lights.spectrum[i], swl.lam) * scene.lights.scale[i]
        pdf_l = light_pmf(
            scene, torch.full(p_b.shape, i, dtype=torch.int32, device=p_b.device)
        ) * UNIFORM_SPHERE_PDF
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
        scene.lights, light_idx, si.p, si.ns, u2, swl, scene.light_kinds,
        tri_sampler=_tri_sampler(scene),
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


def _has_proportional_pdfs(scene) -> bool:
    """Only stochastic layered coats return proportional pdfs; none of
    them is ported, so the MIS re-evaluation never runs."""
    return False


def _prepare_hit(scene, si, ray_d):
    """Per-hit preparation.  Its texture footprints and normal / bump
    mapping feed textures only, which are not ported: the no-op form."""
    return si


def _resolve_mix(scene, si, sampler, s_state):
    """Mix materials are not ported: the no-op form draws no dimension."""
    return si, s_state


def _apply_dispersion(scene, si, alive, beta, terminated):
    """No dispersive dielectric is ported: beta and the flag pass through."""
    return beta, terminated


def _with_rng_key(scene, bsdf_ctx, s_state):
    """No RNG-keyed (layered) BSDF is ported: the context is unchanged."""
    return bsdf_ctx


def _bsdf_ctx(scene, si, swl):
    """Per-hit BSDF context: empty without textures."""
    return {}
