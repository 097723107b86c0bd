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

The reference's ``lax.while_loop`` becomes a Python loop here.  Its stop
test ``busy.any()`` and the done-lane write (which indexes the done lanes)
each cost one device-to-host sync per iteration; at the bench size that is
a few hundred per wave, accepted for now.
"""

from __future__ import annotations

import dataclasses

import torch

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
    _with_rng_key,
    sample_ld_prepare,
)
from shimmer_tpu_torch.materials.material import bsdf_sample
from shimmer_tpu_torch.ops.ray import offset_ray_origin
from shimmer_tpu_torch.ops.vecmath import abs_dot
from shimmer_tpu_torch.samplers import SamplerState
from shimmer_tpu_torch.scene import Scene, scene_intersect_merged
from shimmer_tpu_torch.spectra.sampled import SampledWavelengths, ss_is_black


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
):
    """Render every (pixel in block) x (sample index) pair with a
    regenerating wavefront.  Returns the updated FilmState and a stats
    dict with the traced ``rays`` and the loop ``iters``."""
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
        swl = film.sample_wavelengths(u_lam)
        u_f, s_state = sampler.get_pixel_2d(s_state)
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
            pool_next=st.pool_next + torch.clamp(torch.sum(free.to(torch.int64)), max=navail),
        )

    def body(st: _WaveState) -> _WaveState:
        swl = SampledWavelengths(lam=st.lam, pdf=st.lam_pdf)
        s_state = SamplerState(pixel_hash=st.s_ph, sample_index=st.s_si, dim=st.s_dim)

        # --- 1. merged trace: extension (closest) + shadow (any hit) ---
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
        si, occluded = scene_intersect_merged(scene, mo, md, mt, n)
        shadow_add = torch.where((st.pend_sh & ~occluded)[..., None], st.ld, 0.0)

        # --- 2. shadow resolution + emission + shading ---
        l = st.l + shadow_add
        alive = st.alive
        miss = alive & ~si.valid
        l = _infinite_le_with_mis(
            scene, st.ray_d, swl, st.beta, st.p_b, st.specular,
            st.prev_p, st.prev_ns, l, miss,
        )
        l = _area_le_with_mis(
            scene, si, swl, st.beta, st.p_b, st.specular,
            st.prev_p, st.prev_ns, l, alive,
        )
        alive = alive & si.valid
        will_shade = alive & (st.depth < max_depth)
        surf_shade = will_shade

        si = _prepare_hit(scene, si, st.ray_d)
        si, s_state = _resolve_mix(scene, si, sampler, s_state)
        beta0, lam_term = _apply_dispersion(scene, si, surf_shade, st.beta, st.lam_term)
        frame = si.shading_frame()
        bsdf_ctx = _with_rng_key(scene, _bsdf_ctx(scene, si, swl), s_state)

        beta_nee = beta0
        ld_new, (sh_o, sh_d, sh_tmax, sh_usable), s_state = sample_ld_prepare(
            scene, si, frame, swl, sampler, s_state, bsdf_ctx
        )
        pend_sh = surf_shade & sh_usable

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
        if _has_proportional_pdfs(scene):
            raise NotImplementedError("proportional BSDF pdfs are not ported yet")
        p_b = torch.where(surf_shade, bs.pdf, st.p_b)
        specular = torch.where(surf_shade, bs.is_specular(), st.specular)
        any_ns = st.any_ns | (surf_shade & ~bs.is_specular())
        eta_scale = torch.where(surf_shade, st.eta_scale * bs.eta * bs.eta, st.eta_scale)
        prev_p = _where_merge(surf_shade, si.p, st.prev_p)
        prev_ns = _where_merge(surf_shade, si.ns, st.prev_ns)
        new_o = offset_ray_origin(si.p, si.n, bs.wi)
        ray_o = _where_merge(surf_shade, new_o, st.ray_o)
        ray_d = _where_merge(surf_shade, bs.wi, st.ray_d)
        alive = surf_shade & bs.valid & ~ss_is_black(beta)

        # Russian roulette on beta * eta_scale past the first bounce.
        u_rr, s_state = sampler.get_1d(s_state)
        past_first = will_shade & (st.depth > 0)
        rr_beta = torch.max(beta * eta_scale[..., None], dim=-1).values
        q = torch.clamp(1.0 - rr_beta, min=0.0)
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
        done = st.busy & ~alive & ~pend_sh
        fw = torch.where(done, st.weight, 0.0)
        rgb = film._clamped_rgb(l, swl) * fw[..., None]
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
        pool_next=torch.zeros((), dtype=torch.int64, device=dev),
        out_rgb=torch.zeros((pool_total, 3), device=dev),
        out_w=torch.zeros(pool_total, device=dev),
        rays=torch.zeros((), device=dev),
        iters=torch.zeros((), device=dev),
    )
    st = regen(st)
    while bool(st.busy.any()):
        st = body(st)

    # One dense per-pixel reduction over the sample axis, then one n-lane
    # scatter-add into the film (item = s_idx * n + p_idx).  On CUDA the
    # accumulation uses atomics, so its order varies from run to run.
    per_px_rgb = st.out_rgb.reshape(n_samples, n, 3).sum(0)
    per_px_w = st.out_w.reshape(n_samples, n).sum(0)
    px = pixel_xy[..., 0].long()
    py = pixel_xy[..., 1].long()
    fs = type(film_state)(
        rgb_sum=film_state.rgb_sum.index_put((py, px), per_px_rgb, accumulate=True),
        weight_sum=film_state.weight_sum.index_put((py, px), per_px_w, accumulate=True),
        rgb_splat=film_state.rgb_splat,
    )
    return fs, {"rays": st.rays, "iters": st.iters}
