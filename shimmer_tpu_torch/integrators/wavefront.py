"""Wavefront path tracer with ray regeneration (port of
``shimmer_tpu/integrators/wavefront.py::render_wave_wavefront``).

A fixed pool of N lanes is kept full.  Each iteration

1. traces ONE merged traversal: every lane's extension ray (closest hit)
   and every lane's pending NEE shadow ray (any hit) as 2N lanes;
2. resolves the shadow contribution, adds MIS-weighted emission for hits
   and escapes, and shades (NEE prepare + BSDF sample + Russian roulette)
   in the reference's sampler dimension order;
3. writes finished paths into a per-(pixel, sample) output slot;
4. regenerates free lanes with camera rays for the next (pixel, sample)
   items of the pool.

In a scene with media each lane carries its current medium: the traced
segment samples a free-flight distance first, and a lane that scatters
shades a medium vertex (NEE through the HG phase function, then a phase
sample) in place of the surface.  With interface media the merged trace
gives the shadow half full interactions, the shadow march crosses
material-less boundaries in three more traversals, a material-less hit
passes the extension ray through, and a declared boundary switches the
lane's medium; an exterior medium alone attenuates a medium vertex's NEE
by exp(-sigma_t |d|).  Every lane draws the medium's sampler dimensions
in every iteration, in the reference's order.

The reference's ``lax.while_loop`` becomes a Python loop here.  Its stop
test ``busy.any()`` and the done-lane write (which indexes the done lanes)
each cost one device-to-host sync per iteration; at the bench size that is
a few hundred per wave, accepted for now, and each is timed by a
``wavefront/sync`` span.

Each stage runs inside a span of ``utils/stats`` (``wavefront/wave``
around the whole, then ``regen``, ``trace``, ``medium``, ``emission``,
``hit``, ``nee``, ``bsdf``, ``roulette``, ``retire`` and ``film``), so a
device trace can be read by stage.
"""

from __future__ import annotations

import dataclasses

import torch

from shimmer_tpu_torch.film.film import add_at_pixels
from shimmer_tpu_torch.film.filters import get_camera_sample
from shimmer_tpu_torch.integrators.path import (
    INF,
    _apply_dispersion,
    _area_le_with_mis,
    _bsdf_ctx,
    _has_proportional_pdfs,
    _infinite_le_with_mis,
    _prepare_hit,
    _resolve_mix,
    _medium_segment,
    _with_regularize,
    _with_rng_key,
    sample_ld_medium_prepare,
    sample_ld_prepare,
    shadow_march_interfaces,
)
from shimmer_tpu_torch.materials.material import bsdf_pdf, bsdf_sample
from shimmer_tpu_torch.materials.scattering import sample_henyey_greenstein
from shimmer_tpu_torch.ops.ray import offset_ray_origin
from shimmer_tpu_torch.ops.vecmath import abs_dot, dot, length
from shimmer_tpu_torch.samplers import SamplerState
from shimmer_tpu_torch.scene import Scene, scene_intersect_merged, scene_intersect_merged_full
from shimmer_tpu_torch.spectra.sampled import SampledWavelengths, ss_is_black
from shimmer_tpu_torch.utils import stats


@dataclasses.dataclass(frozen=True)
class _WaveState:
    busy: torch.Tensor       # (N,) bool: lane carries an in-flight path
    alive: torch.Tensor      # (N,) bool: extension ray pending
    pend_sh: torch.Tensor    # (N,) bool: shadow ray pending
    depth: torch.Tensor      # (N,) int32: bounces shaded so far
    ray_o: torch.Tensor      # (N, 3)
    ray_d: torch.Tensor      # (N, 3)
    sh_o: torch.Tensor       # (N, 3)
    sh_d: torch.Tensor       # (N, 3)
    sh_tmax: torch.Tensor    # (N,)
    ld: torch.Tensor         # (N, 4) pending NEE contribution
    l: torch.Tensor          # (N, 4)
    beta: torch.Tensor       # (N, 4)
    p_b: torch.Tensor        # (N,)
    eta_scale: torch.Tensor  # (N,)
    specular: torch.Tensor   # (N,) bool
    any_ns: torch.Tensor     # (N,) bool
    prev_p: torch.Tensor     # (N, 3)
    prev_ns: torch.Tensor    # (N, 3)
    lam: torch.Tensor        # (N, 4)
    lam_pdf: torch.Tensor    # (N, 4)
    lam_term: torch.Tensor   # (N,) bool
    s_ph: torch.Tensor       # (N,) sampler morton index
    s_si: torch.Tensor       # (N,) sampler sample index
    s_dim: torch.Tensor      # (N,) sampler dimension
    pixel_xy: torch.Tensor   # (N, 2) int32
    weight: torch.Tensor     # (N,) filter weight
    item: torch.Tensor       # (N,) int64: pool item of the lane
    cur_med: torch.Tensor    # (N,) int32: the lane's current medium (-1: vacuum)
    sh_med: torch.Tensor     # (N,) int32: the medium at the shadow origin
    pool_next: torch.Tensor  # () int64
    out_rgb: torch.Tensor    # (pool, 3): one slot per (sample, pixel) item
    out_w: torch.Tensor      # (pool,)
    rays: torch.Tensor       # () f32: traced rays
    iters: torch.Tensor      # () f32: loop iterations


def _where_merge(cond, new, old):
    c = cond
    if new.ndim > cond.ndim:
        c = cond.reshape(cond.shape + (1,) * (new.ndim - cond.ndim))
    return torch.where(c, new, old)


@stats.span("wavefront/wave")
def render_wave_wavefront(
    scene: Scene,
    camera,
    film,
    sampler,
    film_state,
    sample_indices,
    pixel_xy,
    pixel_valid,
    max_depth: int = 5,
    regularize: bool = False,
    pixel_spread: float = 0.0,
    disable_pixel_jitter: bool = False,
    disable_wavelength_jitter: bool = False,
):
    """Render every (pixel in block) x (sample index) pair with a
    regenerating wavefront.  Returns the updated FilmState and a stats
    dict with the traced ``rays`` and the loop ``iters``.  ``pixel_spread``
    is the angular pixel footprint that sizes texture filtering;
    ``regularize`` roughens near-specular lobes past a path's first
    non-specular bounce; the jitter switches pin the filter or the
    wavelength draw at 0.5."""
    dev = scene.device
    n = pixel_xy.shape[0]
    n_samples = int(sample_indices.shape[0])
    pool_total = n * n_samples
    sample_indices = torch.as_tensor(sample_indices, device=dev).to(torch.int64)
    pixel_xy = pixel_xy.to(dev)
    pixel_valid = (
        torch.ones(n, dtype=torch.bool, device=dev)
        if pixel_valid is None
        else pixel_valid.to(dev)
    )

    cam_med = torch.full((n,), scene.camera_medium, dtype=torch.int32, device=dev)
    iface_med = scene.media is not None and scene.has_interface_media
    has_med = scene.media is not None and (scene.camera_medium >= 0 or iface_med)

    @stats.span("wavefront/regen")
    def regen(st: _WaveState) -> _WaveState:
        free = ~st.busy
        navail = pool_total - st.pool_next
        rank = torch.cumsum(free.to(torch.int64), 0) - 1
        take = free & (rank < navail)
        item = torch.clamp(st.pool_next + rank, 0, pool_total - 1)
        p_idx = item % n
        s_idx = item // n
        px = pixel_xy[p_idx]
        samp = sample_indices[s_idx]
        valid = pixel_valid[p_idx]

        s_state = sampler.start_pixel_sample(px, samp)
        u_lam, s_state = sampler.get_1d(s_state)
        if disable_wavelength_jitter:
            u_lam = torch.full_like(u_lam, 0.5)
        swl = film.sample_wavelengths(u_lam)
        u_f, s_state = sampler.get_pixel_2d(s_state)
        if disable_pixel_jitter:
            u_f = torch.full_like(u_f, 0.5)
        u_l, s_state = sampler.get_2d(s_state)
        p_film, w, u_l = get_camera_sample(film.filter, px, u_f, u_l)
        ray = camera.generate_ray(p_film, u_l)

        def m(new, old):
            return _where_merge(take, new, old)

        zero3 = torch.zeros((n, 3), device=dev)
        zero4 = torch.zeros((n, 4), device=dev)
        return dataclasses.replace(
            st,
            busy=st.busy | take,
            alive=torch.where(take, valid, st.alive),
            pend_sh=torch.where(take, False, st.pend_sh),
            depth=m(torch.zeros(n, dtype=torch.int32, device=dev), st.depth),
            ray_o=m(ray.o, st.ray_o),
            ray_d=m(ray.d, st.ray_d),
            ld=m(zero4, st.ld),
            l=m(zero4, st.l),
            beta=m(torch.ones((n, 4), device=dev), st.beta),
            p_b=m(torch.ones(n, device=dev), st.p_b),
            eta_scale=m(torch.ones(n, device=dev), st.eta_scale),
            specular=st.specular | take,
            any_ns=torch.where(take, False, st.any_ns),
            prev_p=m(ray.o, st.prev_p),
            prev_ns=m(zero3, st.prev_ns),
            lam=m(swl.lam, st.lam),
            lam_pdf=m(swl.pdf, st.lam_pdf),
            lam_term=torch.where(take, False, st.lam_term),
            s_ph=m(s_state.pixel_hash, st.s_ph),
            s_si=m(s_state.sample_index, st.s_si),
            s_dim=m(s_state.dim, st.s_dim),
            pixel_xy=m(px.to(torch.int32), st.pixel_xy),
            weight=m(torch.where(valid, w, 0.0), st.weight),
            item=m(item, st.item),
            cur_med=m(cam_med, st.cur_med),
            sh_med=m(cam_med, st.sh_med),
            pool_next=st.pool_next + torch.clamp(torch.sum(free.to(torch.int64)), max=navail),
        )

    def body(st: _WaveState) -> _WaveState:
        swl = SampledWavelengths(lam=st.lam, pdf=st.lam_pdf)
        s_state = SamplerState(pixel_hash=st.s_ph, sample_index=st.s_si, dim=st.s_dim)

        # --- 1. merged trace: extension (closest) + shadow (any hit) ---
        with stats.span("wavefront/trace"):
            rays = st.rays + torch.sum(st.alive.to(torch.float32)) + torch.sum(
                st.pend_sh.to(torch.float32)
            )
            mo = torch.cat([st.ray_o, st.sh_o], dim=0)
            md = torch.cat([st.ray_d, st.sh_d], dim=0)
            mt = torch.cat(
                [
                    torch.where(st.alive, INF, -INF),
                    torch.where(st.pend_sh, st.sh_tmax, -INF),
                ],
                dim=0,
            )
            if iface_med:
                # Closest hits on both halves: the march crosses material-less
                # boundaries, three more traversals of the shadow lanes.
                si, si_sh = scene_intersect_merged_full(scene, mo, md, mt, n)
                visible, tr_sh = shadow_march_interfaces(
                    scene, swl, st.sh_o, st.sh_d, st.sh_tmax, st.pend_sh, st.sh_med, si0=si_sh)
                shadow_add = torch.where(visible[..., None], st.ld * tr_sh, 0.0)
            else:
                si, occluded = scene_intersect_merged(scene, mo, md, mt, n)
                shadow_add = torch.where((st.pend_sh & ~occluded)[..., None], st.ld, 0.0)

        # --- 2. shadow resolution + emission + shading ---
        alive = st.alive
        beta_st = st.beta
        scattered = None
        if has_med:
            # Free-flight sampling over the traced segment, before any
            # surface draw.
            with stats.span("wavefront/medium"):
                mid = st.cur_med if iface_med else cam_med
                s_state, beta_st, scattered, (sig_t, g_m, t_m) = _medium_segment(
                    scene, sampler, swl, s_state, mid, si, alive, beta_st)
        with stats.span("wavefront/emission"):
            l = st.l + shadow_add
            reach = alive if scattered is None else alive & ~scattered
            miss = reach & ~si.valid
            l = _infinite_le_with_mis(
                scene, st.ray_d, swl, beta_st, st.p_b, st.specular,
                st.prev_p, st.prev_ns, l, miss,
            )
            l = _area_le_with_mis(
                scene, si, swl, beta_st, st.p_b, st.specular,
                st.prev_p, st.prev_ns, l, reach,
            )
            alive = alive & (si.valid if scattered is None else si.valid | scattered)
            will_shade = alive & (st.depth < max_depth)
            surf_shade = will_shade if scattered is None else will_shade & si.valid & ~scattered
            med_shade = None if scattered is None else will_shade & scattered

        with stats.span("wavefront/hit"):
            si = _prepare_hit(scene, si, st.ray_d, pixel_spread)
            si, s_state = _resolve_mix(scene, si, sampler, s_state)
            beta0, lam_term = _apply_dispersion(scene, si, surf_shade, beta_st, st.lam_term)
            frame = si.shading_frame()
            bsdf_ctx = _with_rng_key(scene, _bsdf_ctx(scene, si, swl), s_state)
            if regularize:
                bsdf_ctx = _with_regularize(bsdf_ctx, st.any_ns)

        with stats.span("wavefront/nee"):
            beta_nee = beta0
            ld_new, (sh_o, sh_d, sh_tmax, sh_usable), s_state = sample_ld_prepare(
                scene, si, frame, swl, sampler, s_state, bsdf_ctx
            )
            pend_sh = surf_shade & sh_usable

        with stats.span("wavefront/bsdf"):
            u2, s_state = sampler.get_2d(s_state)
            uc, s_state = sampler.get_1d(s_state)
            bs = bsdf_sample(
                scene.materials, scene.material_kinds, si.material_id,
                frame, si.ns, si.wo, u2, uc, swl, **bsdf_ctx,
            )
            cos_f = abs_dot(bs.wi, si.ns)
            step = torch.where(
                (bs.pdf > 0.0)[..., None],
                bs.f * (cos_f / torch.clamp(bs.pdf, min=1e-20))[..., None],
                0.0,
            )
            beta = torch.where(surf_shade[..., None], beta0 * step, beta0)
            p_b_new = bs.pdf
            if _has_proportional_pdfs(scene):
                # A layered coat's sample pdf is proportional only: MIS on the
                # next hit needs the true (estimated) pdf.
                p_b_new = torch.where(
                    bs.pdf_is_proportional,
                    bsdf_pdf(
                        scene.materials, scene.material_kinds, si.material_id,
                        frame, si.ns, si.wo, bs.wi, swl, **bsdf_ctx,
                    ),
                    bs.pdf,
                )
            p_b = torch.where(surf_shade, p_b_new, st.p_b)
            specular = torch.where(surf_shade, bs.is_specular(), st.specular)
            any_ns = st.any_ns | (surf_shade & ~bs.is_specular())
            eta_scale = torch.where(surf_shade, st.eta_scale * bs.eta * bs.eta, st.eta_scale)
            prev_p = _where_merge(surf_shade, si.p, st.prev_p)
            prev_ns = _where_merge(surf_shade, si.ns, st.prev_ns)
            new_o = offset_ray_origin(si.p, si.n, bs.wi)
            ray_o = _where_merge(surf_shade, new_o, st.ray_o)
            ray_d = _where_merge(surf_shade, bs.wi, st.ray_d)
            alive = surf_shade & bs.valid & ~ss_is_black(beta)

        if has_med:
            # --- medium-vertex shading ---
            with stats.span("wavefront/medium"):
                p_med = st.ray_o + t_m[..., None] * st.ray_d
                wo_m = -st.ray_d
                ld_med, (sh_o_m, sh_d_m, sh_tmax_m, usable_m), s_state = (
                    sample_ld_medium_prepare(scene, p_med, wo_m, g_m, swl, sampler, s_state))
                u2_m, s_state = sampler.get_2d(s_state)
                wi_m, pdf_ph = sample_henyey_greenstein(wo_m, g_m, u2_m)
                scat3 = med_shade[..., None]
                ld_new = torch.where(scat3, ld_med, ld_new)
                sh_o = torch.where(scat3, sh_o_m, sh_o)
                sh_d = torch.where(scat3, sh_d_m, sh_d)
                sh_tmax = torch.where(med_shade, sh_tmax_m, sh_tmax)
                pend_sh = pend_sh | (med_shade & usable_m)
                if not iface_med:
                    # Exact for one exterior medium; an interface scene takes
                    # the march's transmittance instead.
                    ld_new = ld_new * torch.exp(-sig_t * length(sh_d)[..., None])
                p_b = torch.where(med_shade, pdf_ph, p_b)
                specular = torch.where(med_shade, False, specular)
                any_ns = any_ns | med_shade
                prev_p = _where_merge(med_shade, p_med, prev_p)
                prev_ns = torch.where(scat3, 0.0, prev_ns)
                ray_o = _where_merge(med_shade, p_med, ray_o)
                ray_d = _where_merge(med_shade, wi_m, ray_d)
                alive = alive | (med_shade & (pdf_ph > 0.0) & ~ss_is_black(beta))

        cur_med = st.cur_med
        sh_med = st.sh_med
        if iface_med:
            # --- interface crossing and material-less pass-through ---
            with stats.span("wavefront/medium"):
                declared = si.med_in > -2
                pass_thru = surf_shade & (si.material_id < 0)
                dirn = -si.wo
                pt3 = pass_thru[..., None]
                ray_o = torch.where(pt3, offset_ray_origin(si.p, si.n, dirn), ray_o)
                ray_d = torch.where(pt3, dirn, ray_d)
                beta = torch.where(pt3, beta_nee, beta)
                p_b = torch.where(pass_thru, st.p_b, p_b)
                specular = torch.where(pass_thru, st.specular, specular)
                prev_p = torch.where(pt3, st.prev_p, prev_p)
                prev_ns = torch.where(pt3, st.prev_ns, prev_ns)
                pend_sh = pend_sh & ~pass_thru
                alive = alive | pass_thru
                # The medium at the new shadow ray's origin.
                sh_side = torch.where(dot(sh_d, si.n) < 0.0, si.med_in, si.med_out)
                sh_med = torch.where(surf_shade & declared, torch.clamp(sh_side, min=-1),
                                     cur_med)
                crossed = surf_shade & declared & alive
                entering = dot(ray_d, si.n) < 0.0
                new_med = torch.where(entering, si.med_in, si.med_out)
                cur_med = torch.where(crossed, torch.clamp(new_med, min=-1), cur_med)

        # Russian roulette on beta * eta_scale past the first bounce.
        with stats.span("wavefront/roulette"):
            u_rr, s_state = sampler.get_1d(s_state)
            past_first = will_shade & (st.depth > 0)
            rr_beta = torch.max(beta * eta_scale[..., None], dim=-1).values
            # Detached: the survival probability is part of the sampling
            # measure, not the integrand.
            q = torch.clamp(1.0 - rr_beta, min=0.0).detach()
            kill = past_first & alive & (u_rr < q)
            beta = torch.where(
                (past_first & alive)[..., None],
                beta / torch.clamp(1.0 - q, min=1e-6)[..., None],
                beta,
            )
            alive = alive & ~kill
            depth = st.depth + will_shade.to(torch.int32)

        # --- 3. per-item output for completed paths ---
        # Each pool item retires exactly once, so the done lanes' slots are
        # distinct: index assignment on the done lanes only.
        with stats.span("wavefront/retire"):
            done = st.busy & ~alive & ~pend_sh
            fw = torch.where(done, st.weight, 0.0)
            rgb = film._clamped_rgb(l, swl) * fw[..., None]
            with stats.span("wavefront/sync"):
                lanes = torch.nonzero(done).squeeze(1)
            slots = st.item[lanes]
            out_rgb = st.out_rgb.index_copy_(0, slots, rgb[lanes])
            out_w = st.out_w.index_copy_(0, slots, fw[lanes])
            busy = st.busy & ~done

            st = dataclasses.replace(
                st,
                busy=busy, alive=alive, pend_sh=pend_sh, depth=depth,
                ray_o=ray_o, ray_d=ray_d,
                sh_o=_where_merge(pend_sh, sh_o, st.sh_o),
                sh_d=_where_merge(pend_sh, sh_d, st.sh_d),
                sh_tmax=torch.where(pend_sh, sh_tmax, st.sh_tmax),
                ld=_where_merge(pend_sh, beta_nee * ld_new, st.ld),
                l=l, beta=beta, p_b=p_b, eta_scale=eta_scale,
                specular=specular, any_ns=any_ns, lam_term=lam_term,
                cur_med=cur_med, sh_med=torch.where(pend_sh, sh_med, st.sh_med),
                prev_p=prev_p, prev_ns=prev_ns,
                s_ph=s_state.pixel_hash, s_si=s_state.sample_index, s_dim=s_state.dim,
                out_rgb=out_rgb, out_w=out_w, rays=rays, iters=st.iters + 1.0,
            )
        # --- 4. regenerate free lanes ---
        return regen(st)

    zero3 = torch.zeros((n, 3), device=dev)
    zero4 = torch.zeros((n, 4), device=dev)
    plus_z = torch.tensor([0.0, 0.0, 1.0], device=dev).expand(n, 3).contiguous()
    zero_u = torch.zeros(n, dtype=torch.int64, device=dev)
    st = _WaveState(
        busy=torch.zeros(n, dtype=torch.bool, device=dev),
        alive=torch.zeros(n, dtype=torch.bool, device=dev),
        pend_sh=torch.zeros(n, dtype=torch.bool, device=dev),
        depth=torch.zeros(n, dtype=torch.int32, device=dev),
        ray_o=zero3, ray_d=plus_z, sh_o=zero3, sh_d=plus_z,
        sh_tmax=torch.ones(n, device=dev),
        ld=zero4, l=zero4,
        beta=torch.ones((n, 4), device=dev),
        p_b=torch.ones(n, device=dev),
        eta_scale=torch.ones(n, device=dev),
        specular=torch.ones(n, dtype=torch.bool, device=dev),
        any_ns=torch.zeros(n, dtype=torch.bool, device=dev),
        prev_p=zero3, prev_ns=zero3,
        lam=torch.full((n, 4), 550.0, device=dev),
        lam_pdf=torch.ones((n, 4), device=dev),
        lam_term=torch.zeros(n, dtype=torch.bool, device=dev),
        s_ph=zero_u, s_si=zero_u, s_dim=zero_u,
        pixel_xy=torch.zeros((n, 2), dtype=torch.int32, device=dev),
        weight=torch.zeros(n, device=dev),
        item=zero_u,
        cur_med=cam_med, sh_med=cam_med,
        pool_next=torch.zeros((), dtype=torch.int64, device=dev),
        out_rgb=torch.zeros((pool_total, 3), device=dev),
        out_w=torch.zeros(pool_total, device=dev),
        rays=torch.zeros((), device=dev),
        iters=torch.zeros((), device=dev),
    )
    st = regen(st)
    while True:
        with stats.span("wavefront/sync"):
            more = bool(st.busy.any())
        if not more:
            break
        st = body(st)

    # One dense per-pixel reduction over the sample axis, then one n-lane
    # scatter-add into the film (item = s_idx * n + p_idx).  Within a wave
    # each pixel index comes once; the padding lanes of the last block are
    # sent to (width, height), outside the image and outside any band of
    # it, and dropped.  So the order of the scatter's adds cannot change a
    # bit of the film, and two renders give equal film states
    # (tests/test_torch_loader_card.py checks this with torch.equal).  Keep it so: a wave that sent
    # one pixel twice with nonzero values would make the film's sums depend
    # on the add order.  A sharded render hands a film view whose scatter
    # space is band-local (parallel/render.py, LocalBandFilm.local_xy).
    with stats.span("wavefront/film"):
        per_px_rgb = st.out_rgb.reshape(n_samples, n, 3).sum(0)
        per_px_w = st.out_w.reshape(n_samples, n).sum(0)
        w_img, h_img = film.resolution
        outside = torch.tensor([w_img, h_img], dtype=pixel_xy.dtype, device=dev)
        scatter_xy = torch.where(pixel_valid[:, None], pixel_xy, outside)
        if hasattr(film, "local_xy"):
            scatter_xy = film.local_xy(scatter_xy)
        fs = type(film_state)(
            rgb_sum=add_at_pixels(film_state.rgb_sum, scatter_xy, per_px_rgb),
            weight_sum=add_at_pixels(film_state.weight_sum, scatter_xy, per_px_w),
            rgb_splat=film_state.rgb_splat,
        )
    return fs, {"rays": st.rays, "iters": st.iters}
