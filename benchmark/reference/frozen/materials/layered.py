"""Layered (coated) BxDFs: coated diffuse and coated conductor (port of
``shimmer_tpu/materials/layered.py``).

A dielectric interface over an opaque bottom (diffuse or conductor),
separated by a medium of optical thickness ``thickness`` with
single-scattering albedo ``albedo`` and HG asymmetry ``g``.  f, sample and
pdf are stochastic random walks between the interfaces:

* the randoms come from a counter-based per-lane stream keyed by the
  sampler state (:class:`_Rng`), draw for draw in the reference's order,
  so the same key gives the same walk;
* the walk is a fixed ``max_depth`` loop in which lanes die by mask;
* both bottoms are opaque, so the BSDF reflects only and the walk exits
  through the top interface.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.frozen.materials import bxdf as bx
from benchmark.reference.frozen.materials import scattering as sc
from benchmark.reference.frozen.materials.bxdf import BSDFSample, select_sample
from benchmark.reference.frozen.materials.conductor_dielectric import (
    _conductor_eta_k,
    _dielectric_eta,
    conductor_f,
    conductor_pdf,
    conductor_sample,
    dielectric_f,
    dielectric_pdf,
    dielectric_sample,
)
from benchmark.reference.frozen.ops import rng as srng
from benchmark.reference.frozen.ops.math import small_gather
from benchmark.reference.frozen.ops.sampling import power_heuristic, sample_exponential
from benchmark.reference.frozen.ops.vecmath import abs_cos_theta, same_hemisphere
from benchmark.reference.frozen.spectra.rgb2spec import sigmoid_poly_sample

# Material kinds this module dispatches (materials/material.py's numbering).
COATED_DIFFUSE = 4
COATED_CONDUCTOR = 5

# Walk bounds (pbrt-v4's defaults).
LAYER_MAX_DEPTH = 10
LAYER_N_SAMPLES = 1


class _Rng:
    """Per-lane counter-based uniform stream: draw i hashes (key, i)."""

    def __init__(self, key, counter: int = 0):
        self.key = srng.u32(key)
        self.c = counter

    def u1(self):
        self.c += 1
        return srng.u32_to_unit_float(srng.hash_combine(self.key, self.c))

    def u2(self):
        a = self.u1()
        return torch.stack([a, self.u1()], dim=-1)


def _tr(dz, w):
    """Medium transmittance between depths, sigma_t = 1."""
    return torch.exp(-torch.abs(dz) / torch.clamp(torch.abs(w[..., 2]), min=1e-9))


class _TopInterface:
    """Dielectric coat interface (top of the layer stack)."""

    def __init__(self, eta, ax, ay):
        self.eta, self.ax, self.ay = eta, ax, ay
        self.specular = sc.effectively_smooth(ax, ay)

    def f(self, wo, wi, radiance=True):
        return dielectric_f(self.eta, wo, wi, self.ax, self.ay, radiance=radiance)

    def sample(self, wo, uc, u2, flags=bx.SAMPLE_ALL, radiance=True):
        return dielectric_sample(self.eta, wo, u2, uc, self.ax, self.ay,
                                 sample_flags=flags, radiance=radiance)

    def pdf(self, wo, wi, flags=bx.SAMPLE_ALL):
        return dielectric_pdf(self.eta, wo, wi, self.ax, self.ay, sample_flags=flags)


class _DiffuseBottom:
    def __init__(self, reflectance):
        self.reflectance = reflectance
        self.specular = torch.zeros(reflectance.shape[:-1], dtype=torch.bool,
                                    device=reflectance.device)

    def f(self, wo, wi, radiance=True):
        return bx.diffuse_f(self.reflectance, wo, wi)

    def sample(self, wo, uc, u2, flags=bx.SAMPLE_ALL, radiance=True):
        return bx.diffuse_sample_f(self.reflectance, wo, u2, uc)

    def pdf(self, wo, wi, flags=bx.SAMPLE_ALL):
        return bx.diffuse_pdf(wo, wi)


class _ConductorBottom:
    def __init__(self, eta, k, ax, ay):
        self.eta, self.k, self.ax, self.ay = eta, k, ax, ay
        self.specular = sc.effectively_smooth(ax, ay)

    def f(self, wo, wi, radiance=True):
        return conductor_f(self.eta, self.k, wo, wi, self.ax, self.ay)

    def sample(self, wo, uc, u2, flags=bx.SAMPLE_ALL, radiance=True):
        return conductor_sample(self.eta, self.k, wo, u2, self.ax, self.ay)

    def pdf(self, wo, wi, flags=bx.SAMPLE_ALL):
        return conductor_pdf(wo, wi, self.ax, self.ay)


def _sample_ok(s: BSDFSample):
    return (
        s.valid & (s.pdf > 0.0) & (torch.abs(s.wi[..., 2]) > 1e-9)
        & (torch.amax(s.f, dim=-1) > 0.0)
    )


def layered_f(top: _TopInterface, bottom, wo, wi, rng_key, thickness, albedo, g,
              albedo_present: bool, n_samples: int = LAYER_N_SAMPLES,
              max_depth: int = LAYER_MAX_DEPTH):
    """Stochastic estimate of the layered BSDF value.  Opaque bottom:
    reflection only; two-sided: both directions flip to the upper
    hemisphere with wo."""
    flip = (wo[..., 2] < 0.0)[..., None]
    wo = torch.where(flip, -wo, wo)
    wi = torch.where(flip, -wi, wi)
    same = same_hemisphere(wo, wi)
    batch = wo.shape[:-1]

    # Entrance-interface reflection term.
    f = torch.where(same[..., None], float(n_samples) * top.f(wo, wi), 0.0)
    exit_z = thickness  # the exit is always the top interface (opaque bottom)

    for s_i in range(n_samples):
        sample_key = srng.hash_combine(rng_key, 1000 + s_i)
        r = _Rng(sample_key)
        # Transmit into the layer, and the virtual exit sample from wi
        # under importance transport.
        wos = top.sample(wo, r.u1(), r.u2(), flags=bx.SAMPLE_TRANSMISSION)
        wis = top.sample(wi, r.u1(), r.u2(), flags=bx.SAMPLE_TRANSMISSION, radiance=False)
        alive = same & _sample_ok(wos) & _sample_ok(wis)

        beta = wos.f * abs_cos_theta(wos.wi)[..., None] / torch.clamp(wos.pdf, min=1e-20)[..., None]
        beta_exit = wis.f / torch.clamp(wis.pdf, min=1e-20)[..., None]
        w = wos.wi
        z = torch.broadcast_to(thickness, batch)
        # The walk's draws continue from counter 4 of the same stream, as
        # the reference's loop does (its prologue drew counters 1-6).
        c = 4
        for depth in range(max_depth):
            r = _Rng(sample_key, counter=c)
            # Russian roulette.
            rr_beta = torch.amax(beta, dim=-1)
            q = torch.clamp(1.0 - rr_beta, min=0.0)
            do_rr = (rr_beta < 0.25) & (depth > 3)
            kill = do_rr & (r.u1() < q)
            beta = torch.where(do_rr[..., None], beta / torch.clamp(1.0 - q, min=1e-6)[..., None],
                               beta)
            alive = alive & ~kill

            at_interface = torch.ones(batch, dtype=torch.bool, device=wo.device)
            if albedo_present:
                # Medium flight and a possible scattering event.
                dz = sample_exponential(r.u1(), 1.0 / torch.clamp(torch.abs(w[..., 2]), min=1e-9))
                zp = torch.where(w[..., 2] > 0.0, z + dz, z - dz)
                scatter = alive & (zp > 0.0) & (zp < thickness)
                # NEE from the scattering event toward wis.
                ph = sc.henyey_greenstein(torch.sum(-w * -wis.wi, dim=-1), g)
                wt = torch.where(top.specular, 1.0, power_heuristic(1.0, wis.pdf, 1.0, ph))
                contrib = (
                    beta * albedo * ph[..., None] * wt[..., None]
                    * _tr(zp - exit_z, wis.wi)[..., None] * beta_exit
                )
                f = f + torch.where(scatter[..., None], contrib, 0.0)
                # Sample the phase function.
                ws, ps_pdf = sc.sample_henyey_greenstein(-w, g, r.u2())
                ps_ok = (ps_pdf > 0.0) & (torch.abs(ws[..., 2]) > 1e-9)
                new_beta = beta * albedo * (
                    sc.henyey_greenstein(torch.sum(-w * ws, dim=-1), g)
                    / torch.clamp(ps_pdf, min=1e-20)
                )[..., None]
                # MIS exit contribution along the phase sample, heading
                # toward the exit.
                toward_exit = (zp < exit_z) & (ws[..., 2] > 0.0)
                f_exit = top.f(-ws, wi)
                exit_pdf = top.pdf(-ws, wi, flags=bx.SAMPLE_TRANSMISSION)
                wt2 = power_heuristic(1.0, ps_pdf, 1.0, exit_pdf)
                mis_c = new_beta * _tr(zp - exit_z, ws)[..., None] * f_exit * wt2[..., None]
                add_mis = scatter & ps_ok & toward_exit & ~top.specular
                f = f + torch.where(add_mis[..., None], mis_c, 0.0)

                beta = torch.where(scatter[..., None], new_beta, beta)
                w = torch.where(scatter[..., None], ws, w)
                z = torch.where(scatter, zp, torch.minimum(torch.clamp(zp, min=0.0), thickness))
                alive = alive & torch.where(scatter, ps_ok, True)
                at_interface = ~scatter
            else:
                # No medium: strict bottom / top alternation, attenuated.
                z = torch.where(z == thickness, 0.0, thickness)
                beta = beta * _tr(thickness, w)[..., None]

            at_bottom = at_interface & (z == 0.0)

            # Bottom (non-exit) interface: NEE toward wis.
            bot_active = alive & at_bottom & ~bottom.specular
            wt = torch.where(
                top.specular, 1.0,
                power_heuristic(1.0, wis.pdf, 1.0, bottom.pdf(-w, -wis.wi)),
            )
            nee = (
                beta * bottom.f(-w, -wis.wi) * abs_cos_theta(wis.wi)[..., None] * wt[..., None]
                * _tr(thickness, wis.wi)[..., None] * beta_exit
            )
            f = f + torch.where(bot_active[..., None], nee, 0.0)

            bs_b = bottom.sample(-w, r.u1(), r.u2())
            # Top (exit) interface: reflection back down.
            bs_t = top.sample(-w, r.u1(), r.u2(), flags=bx.SAMPLE_REFLECTION)
            bs = select_sample(at_bottom, bs_b, bs_t)
            step_ok = _sample_ok(bs)
            new_beta = beta * bs.f * (abs_cos_theta(bs.wi) / torch.clamp(bs.pdf, min=1e-20))[..., None]
            new_w = bs.wi

            # MIS exit contribution of the fresh bottom sample; a specular
            # bottom has no NEE strategy, so the sample takes full weight.
            f_exit = top.f(-new_w, wi)
            exit_pdf = top.pdf(-new_w, wi, flags=bx.SAMPLE_TRANSMISSION)
            wt2 = torch.where(bottom.specular, 1.0, power_heuristic(1.0, bs.pdf, 1.0, exit_pdf))
            mis_c = new_beta * _tr(thickness, new_w)[..., None] * f_exit * wt2[..., None]
            add_mis = alive & at_bottom & step_ok & ~top.specular
            f = f + torch.where(add_mis[..., None], mis_c, 0.0)

            upd = (alive & at_interface)[..., None]
            beta = torch.where(upd, new_beta, beta)
            w = torch.where(upd, new_w, w)
            alive = alive & torch.where(at_interface, step_ok, True)
            c = r.c

    return f / float(n_samples)


def layered_sample(top: _TopInterface, bottom, wo, uc, u2, rng_key, thickness, albedo, g,
                   albedo_present: bool, max_depth: int = LAYER_MAX_DEPTH) -> BSDFSample:
    """Sample the layered BSDF by an explicit random walk.  The returned
    pdf is proportional: the true pdf is ``layered_pdf``'s estimate."""
    batch, dev = wo.shape[:-1], wo.device
    flip = wo[..., 2] < 0.0
    wo_f = torch.where(flip[..., None], -wo, wo)

    bs0 = top.sample(wo_f, uc, u2)
    ok0 = _sample_ok(bs0)
    is_refl0 = (bs0.flags & bx.REFLECTION) != 0
    proportional = torch.ones(batch, dtype=torch.bool, device=dev)
    ones = torch.ones(batch, device=dev)
    # Entrance reflection: returned directly.
    entrance = BSDFSample(
        f=bs0.f, wi=torch.where(flip[..., None], -bs0.wi, bs0.wi), pdf=bs0.pdf,
        flags=bs0.flags, eta=ones, pdf_is_proportional=proportional, valid=ok0 & is_refl0,
    )

    f = bs0.f * abs_cos_theta(bs0.wi)[..., None]
    pdf = bs0.pdf
    w = bs0.wi
    z = torch.broadcast_to(thickness, batch)
    specular_path = bs0.is_specular()
    walking = ok0 & ~is_refl0  # transmitted into the layer
    done = torch.zeros(batch, dtype=torch.bool, device=dev)
    out = BSDFSample.invalid(batch, dev)
    c = 0
    for depth in range(max_depth):
        r = _Rng(rng_key, counter=c)
        # Russian roulette.
        rr_beta = torch.amax(f, dim=-1) / torch.clamp(pdf, min=1e-20)
        q = torch.clamp(1.0 - rr_beta, min=0.0)
        do_rr = walking & (rr_beta < 0.25) & (depth > 3)
        kill = do_rr & (r.u1() < q)
        pdf = torch.where(do_rr, pdf * torch.clamp(1.0 - q, min=1e-6), pdf)
        walking = walking & ~kill

        at_interface = torch.ones(batch, dtype=torch.bool, device=dev)
        if albedo_present:
            dz = sample_exponential(r.u1(), 1.0 / torch.clamp(torch.abs(w[..., 2]), min=1e-9))
            zp = torch.where(w[..., 2] > 0.0, z + dz, z - dz)
            scatter = walking & (zp > 0.0) & (zp < thickness)
            ws, ps_pdf = sc.sample_henyey_greenstein(-w, g, r.u2())
            ps_ok = (ps_pdf > 0.0) & (torch.abs(ws[..., 2]) > 1e-9)
            ph = sc.henyey_greenstein(torch.sum(-w * ws, dim=-1), g)
            f = torch.where(scatter[..., None], f * albedo * ph[..., None], f)
            pdf = torch.where(scatter, pdf * ps_pdf, pdf)
            specular_path = specular_path & ~scatter
            w = torch.where(scatter[..., None], ws, w)
            z = torch.where(scatter, zp, torch.minimum(torch.clamp(zp, min=0.0), thickness))
            walking = walking & torch.where(scatter, ps_ok, True)
            at_interface = ~scatter
        else:
            z = torch.where(z == thickness, 0.0, thickness)
            f = f * _tr(thickness, w)[..., None]

        at_bottom = at_interface & (z == 0.0)
        bs_b = bottom.sample(-w, r.u1(), r.u2())
        bs_t = top.sample(-w, r.u1(), r.u2())
        bs = select_sample(at_bottom, bs_b, bs_t)
        step_ok = _sample_ok(bs)
        walking = walking & torch.where(at_interface, step_ok, True)

        stepped = walking & at_interface
        f = torch.where(stepped[..., None], f * bs.f, f)
        pdf = torch.where(stepped, pdf * bs.pdf, pdf)
        specular_path = specular_path & torch.where(stepped, bs.is_specular(), True)
        w = torch.where(stepped[..., None], bs.wi, w)

        # Transmission through the top is the exit.
        exits = stepped & ((bs.flags & bx.TRANSMISSION) != 0) & ~at_bottom
        out_flags = (
            torch.where(same_hemisphere(wo_f, w), bx.REFLECTION, bx.TRANSMISSION)
            | torch.where(specular_path, bx.SPECULAR, bx.GLOSSY)
        )
        cand = BSDFSample(
            f=f, wi=torch.where(flip[..., None], -w, w), pdf=pdf,
            flags=out_flags.to(torch.int32), eta=ones, pdf_is_proportional=proportional,
            valid=exits & (pdf > 0.0),
        )
        out = select_sample(exits & ~done, cand, out)
        done = done | exits
        walking = walking & ~exits

        # Cosine factor after an interface that did not exit.
        f = torch.where(stepped[..., None] & ~exits[..., None],
                        f * abs_cos_theta(bs.wi)[..., None], f)
        c = r.c
    return select_sample(ok0 & is_refl0, entrance, out)


def layered_pdf(top: _TopInterface, bottom, wo, wi, rng_key, n_samples: int = LAYER_N_SAMPLES):
    """Stochastic pdf estimate blended with a uniform-sphere floor:
    0.9 * estimate + 0.1 / (4 pi)."""
    flip = (wo[..., 2] < 0.0)[..., None]
    wo = torch.where(flip, -wo, wo)
    wi = torch.where(flip, -wi, wi)
    same = same_hemisphere(wo, wi)
    # A stream of its own, apart from layered_sample's walk on the same key.
    r = _Rng(srng.hash_combine(rng_key, 77777))

    # Direct top-interface reflection strategy.
    pdf_sum = torch.where(same, float(n_samples) * top.pdf(wo, wi, flags=bx.SAMPLE_REFLECTION), 0.0)
    for _ in range(n_samples):
        # Transmission-reflection-transmission estimate.
        wos = top.sample(wo, r.u1(), r.u2(), flags=bx.SAMPLE_TRANSMISSION)
        wis = top.sample(wi, r.u1(), r.u2(), flags=bx.SAMPLE_TRANSMISSION, radiance=False)
        ok = same & _sample_ok(wos) & _sample_ok(wis)
        # Specular top: the bottom pdf of the deterministic refraction pair.
        pdf_spec = bottom.pdf(-wos.wi, -wis.wi)
        # Otherwise an MIS-weighted two-strategy estimate.
        rs = bottom.sample(-wos.wi, r.u1(), r.u2())
        rs_ok = _sample_ok(rs)
        r_pdf = bottom.pdf(-wos.wi, -wis.wi)
        wt = power_heuristic(1.0, wis.pdf, 1.0, r_pdf)
        t_pdf = top.pdf(-rs.wi, wi, flags=bx.SAMPLE_TRANSMISSION)
        wt_t = power_heuristic(1.0, rs.pdf, 1.0, t_pdf)
        pdf_nonspec = torch.where(
            bottom.specular, top.pdf(-rs.wi, wi), wt * r_pdf + wt_t * t_pdf,
        ) * rs_ok.to(torch.float32)
        est = torch.where(top.specular, pdf_spec, pdf_nonspec)
        pdf_sum = pdf_sum + torch.where(ok, est, 0.0)

    uniform = 1.0 / (4.0 * math.pi)
    return 0.9 * pdf_sum / float(n_samples) + 0.1 * uniform


# --- material-table dispatch glue (called from materials.material) ---


def _interfaces(materials, mat_id, swl, spectra_table, tex=None):
    """Top interface and both bottoms from material-table rows.  A
    textured reflectance (in ``tex``) drives the diffuse bottom and the
    conductor's reflectance mode; the roughnesses stay the columns'."""
    ax = sc.roughness_to_alpha(small_gather(materials.uroughness, mat_id))
    ay = sc.roughness_to_alpha(small_gather(materials.vroughness, mat_id))
    ax, ay = sc.clamp_alpha(ax, ay)
    # The coat's eta is always the constant column.
    top = _TopInterface(_dielectric_eta(materials, mat_id, swl, None), ax, ay)
    refl = tex.get("reflectance") if tex else None
    if refl is None:
        refl = sigmoid_poly_sample(small_gather(materials.reflectance, mat_id), swl.lam)
    bot_d = _DiffuseBottom(refl)
    bax = sc.roughness_to_alpha(small_gather(materials.bot_uroughness, mat_id))
    bay = sc.roughness_to_alpha(small_gather(materials.bot_vroughness, mat_id))
    bax, bay = sc.clamp_alpha(bax, bay)
    c_eta, c_k = _conductor_eta_k(materials, mat_id, swl, spectra_table, tex)
    return top, bot_d, _ConductorBottom(c_eta, c_k, bax, bay)


def _layer_params(materials, mat_id, swl):
    thickness = small_gather(materials.thickness, mat_id)
    g = small_gather(materials.hg_g, mat_id)
    albedo = sigmoid_poly_sample(small_gather(materials.albedo, mat_id), swl.lam)
    return thickness, g, albedo


def _coats(materials, kinds_present, mat_id, kind, swl, spectra_table, tex):
    """(kind, top, bottom) for each coated kind in the scene that a lane
    has.  A walk costs thousands of small kernels, so a kind no lane has
    is skipped: its lanes would all be deselected, and each lane's stream
    is its own, so no other lane's draws change."""
    for mk, is_cond in ((COATED_DIFFUSE, False), (COATED_CONDUCTOR, True)):
        if mk in kinds_present and bool(torch.any(kind == mk)):
            top, bot_d, bot_c = _interfaces(materials, mat_id, swl, spectra_table, tex)
            yield mk, top, bot_c if is_cond else bot_d


def coated_f(materials, kinds_present, mat_id, kind, wo, wi, swl, f, rng_key,
             tex=None, spectra_table=None):
    thickness, g, albedo = _layer_params(materials, mat_id, swl)
    for mk, top, bot in _coats(materials, kinds_present, mat_id, kind, swl, spectra_table, tex):
        key = srng.hash_combine(rng_key, mk)
        val = layered_f(top, bot, wo, wi, key, thickness, albedo, g, materials.layer_medium)
        f = torch.where((kind == mk)[..., None], val, f)
    return f


def coated_sample(materials, kinds_present, mat_id, kind, wo, u2, uc, swl, out, rng_key,
                  tex=None, spectra_table=None):
    thickness, g, albedo = _layer_params(materials, mat_id, swl)
    for mk, top, bot in _coats(materials, kinds_present, mat_id, kind, swl, spectra_table, tex):
        key = srng.hash_combine(rng_key, 16 + mk)
        s = layered_sample(top, bot, wo, uc, u2, key, thickness, albedo, g,
                           materials.layer_medium)
        out = select_sample(kind == mk, s, out)
    return out


def coated_pdf(materials, kinds_present, mat_id, kind, wo, wi, swl, pdf, rng_key,
               tex=None, spectra_table=None):
    for mk, top, bot in _coats(materials, kinds_present, mat_id, kind, swl, spectra_table, tex):
        key = srng.hash_combine(rng_key, 32 + mk)
        pdf = torch.where(kind == mk, layered_pdf(top, bot, wo, wi, key), pdf)
    return pdf
