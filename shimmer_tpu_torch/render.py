"""Render orchestration (port of ``shimmer_tpu/render.py``).

The image is split into fixed-size pixel blocks; each wave renders
``wave_spp`` sample indices of one block and adds them into the film
state.  The production path is the regenerating wavefront
(``integrators/wavefront.py``); ``wavefront=False`` runs the masked
megakernel instead, one estimator call (``INTEGRATORS``) per sample index
over the block's lanes, each sample scattered into its own pixel.
``make_replay_wavefront_renderer`` differentiates the wavefront: its
backward replays the wave's paths through the megakernel.
"""

from __future__ import annotations

import numpy as np
import torch

from shimmer_tpu_torch.config import f32, resolve_device
from shimmer_tpu_torch.film.film import FilmState, RgbFilm
from shimmer_tpu_torch.film.filters import get_camera_sample
from shimmer_tpu_torch.integrators.path import li_path, li_random_walk, li_simple_path
from shimmer_tpu_torch.integrators.wavefront import render_wave_wavefront
from shimmer_tpu_torch.scene import Scene, grad_tensor_fields, with_tensor_fields
from shimmer_tpu_torch.spectra.sampled import SampledWavelengths
from shimmer_tpu_torch.utils import stats
from shimmer_tpu_torch.utils.checkpoint import RenderCheckpointer

INTEGRATORS = {
    "path": li_path,
    "simplepath": li_simple_path,
    "randomwalk": li_random_walk,
}
DEFAULT_PIXEL_BLOCK = 1 << 15


def _spp_spread(camera, sampler):
    """The camera's pixel spread shrunk with the sample count (0 for a
    camera without one)."""
    spread = getattr(camera, "pixel_spread", 0.0)
    if spread:
        spread = spread * max(0.125, 1.0 / np.sqrt(max(sampler.samples_per_pixel, 1)))
    return spread


def render_pixel_samples(scene: Scene, camera, film: RgbFilm, sampler, li_fn, opts: dict,
                         film_state: FilmState, sample_indices, pixel_xy, pixel_valid=None,
                         max_depth: int = 5, use_visible_wavelengths: bool = True,
                         disable_pixel_jitter: bool = False,
                         disable_wavelength_jitter: bool = False):
    """The megakernel's wave body: one estimator call per sample index over
    the block's lanes, each lane's sample added to its pixel.  Returns the
    film state and the traced rays (summed over the calls of an estimator
    that counts them, else None).

    Draws in the reference's order: wavelengths, filter, lens.  A
    non-finite estimate is zeroed.  Padded lanes (``pixel_valid`` False)
    get filter weight 0 and are sent outside the image, where the film
    drops them; every other lane names a pixel of its own, so each call's
    adds go to distinct pixels."""
    rays = None
    if pixel_valid is not None:
        w_img, h_img = film.resolution
        outside = torch.tensor([w_img, h_img], dtype=pixel_xy.dtype, device=pixel_xy.device)
        scatter_xy = torch.where(pixel_valid[..., None], pixel_xy, outside)
    else:
        scatter_xy = pixel_xy
    for sample_index in sample_indices:
        s_state = sampler.start_pixel_sample(pixel_xy, sample_index)
        u_lam, s_state = sampler.get_1d(s_state)
        if disable_wavelength_jitter:
            u_lam = torch.full_like(u_lam, 0.5)
        if use_visible_wavelengths:
            swl = film.sample_wavelengths(u_lam)
        else:
            swl = SampledWavelengths.sample_uniform(u_lam)
        u_filter, s_state = sampler.get_pixel_2d(s_state)
        if disable_pixel_jitter:
            u_filter = torch.full_like(u_filter, 0.5)
        u_lens, s_state = sampler.get_2d(s_state)
        p_film, weight, u_lens = get_camera_sample(film.filter, pixel_xy, u_filter, u_lens)
        if pixel_valid is not None:
            weight = torch.where(pixel_valid, weight, 0.0)
        ray = camera.generate_ray(p_film, u_lens)
        out = li_fn(scene, ray, swl, sampler, s_state, max_depth, **opts)
        if isinstance(out, tuple):
            out, st = out
            rays = st["rays"] if rays is None else rays + st["rays"]
        bad = torch.any(~torch.isfinite(out), dim=-1)
        l = torch.where(bad[..., None], 0.0, out)
        film_state = film.add_samples(film_state, scatter_xy, l, swl, weight)
    return film_state, rays


def full_image_pixels(film: RgbFilm, device=None):
    """(W * H, 2) int32 pixel coordinates in row-major order."""
    return band_pixels(film, 0, film.resolution[1], resolve_device(device))


def band_pixels(film: RgbFilm, row0: int, rows: int, device) -> torch.Tensor:
    """(rows * W, 2) int32 pixel coordinates of rows ``row0 .. row0 +
    rows - 1``, row-major."""
    w = film.resolution[0]
    ys, xs = torch.meshgrid(torch.arange(row0, row0 + rows, dtype=torch.int32),
                            torch.arange(w, dtype=torch.int32), indexing="ij")
    return torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1).to(device)


def _megakernel_opts(integrator, regularize, integrator_options, camera, sampler):
    opts = dict(integrator_options or {})
    if integrator == "path" and regularize:
        opts["regularize"] = True
    spread = _spp_spread(camera, sampler)
    if spread and "pixel_spread" not in opts:
        opts["pixel_spread"] = spread
    if integrator == "path":
        opts.setdefault("return_stats", True)
    return opts


def make_wave_renderer(scene: Scene, camera, film: RgbFilm, sampler, integrator: str = "path",
                       max_depth: int = 5, regularize: bool = False,
                       use_visible_wavelengths: bool = True, integrator_options: dict | None = None,
                       disable_pixel_jitter: bool = False, disable_wavelength_jitter: bool = False):
    """Megakernel wave function (film_state, sample_indices, pixel_xy,
    pixel_valid) -> (film_state, stats); stats['rays'] is the traced ray
    count of the path estimator (None for the others)."""
    li_fn = INTEGRATORS[integrator]
    opts = _megakernel_opts(integrator, regularize, integrator_options, camera, sampler)

    def render_samples(film_state, sample_indices, pixel_xy, pixel_valid):
        fs, rays = render_pixel_samples(
            scene, camera, film, sampler, li_fn, opts, film_state, sample_indices, pixel_xy,
            pixel_valid=pixel_valid, max_depth=max_depth,
            use_visible_wavelengths=use_visible_wavelengths,
            disable_pixel_jitter=disable_pixel_jitter,
            disable_wavelength_jitter=disable_wavelength_jitter,
        )
        return fs, {"rays": rays}

    return render_samples


def make_scan_wave_renderer(scene: Scene, camera, film: RgbFilm, sampler,
                            integrator: str = "path", max_depth: int = 5,
                            regularize: bool = False, use_visible_wavelengths: bool = True,
                            integrator_options: dict | None = None):
    """Whole-wave megakernel function (film_state, sample_indices, blocks,
    valids) -> film_state over every pixel block in turn."""
    li_fn = INTEGRATORS[integrator]
    opts = _megakernel_opts(integrator, regularize, integrator_options, camera, sampler)

    def render_wave(film_state: FilmState, sample_indices, blocks, valids):
        for pixel_xy, pixel_valid in zip(blocks, valids):
            film_state, _ = render_pixel_samples(
                scene, camera, film, sampler, li_fn, opts, film_state, sample_indices, pixel_xy,
                pixel_valid=pixel_valid, max_depth=max_depth,
                use_visible_wavelengths=use_visible_wavelengths,
            )
        return film_state

    return render_wave


def make_wavefront_renderer(scene: Scene, camera, film: RgbFilm, sampler, max_depth: int = 5,
                            regularize: bool = False, disable_pixel_jitter: bool = False,
                            disable_wavelength_jitter: bool = False):
    """Wave function (film_state, sample_indices, pixel_xy, pixel_valid)
    -> (film_state, stats); stats['rays'] is the exact traced ray count of
    the wave and stats['iters'] its loop iterations.  The camera's pixel
    spread, shrunk with the sample count, sizes the texture footprints."""
    spread = _spp_spread(camera, sampler)

    def render_samples(film_state, sample_indices, pixel_xy, pixel_valid):
        return render_wave_wavefront(
            scene, camera, film, sampler, film_state, sample_indices,
            pixel_xy, pixel_valid, max_depth=max_depth, regularize=regularize,
            pixel_spread=spread, disable_pixel_jitter=disable_pixel_jitter,
            disable_wavelength_jitter=disable_wavelength_jitter,
        )

    return render_samples


class _ReplayWave(torch.autograd.Function):
    """One wavefront wave whose backward replays its paths through the
    megakernel.  Inputs: the replay's settings (``_Replay``), the film
    state's three tensors, the sample indices, ``pixel_xy``,
    ``pixel_valid``, then the scene's tensors that require grad.
    Outputs: the film state's three tensors, and the wave's traced rays
    and loop iterations (not differentiable)."""

    @staticmethod
    def forward(ctx, replay, rgb_sum, weight_sum, rgb_splat, sample_indices, pixel_xy,
                pixel_valid, *leaves):
        # Only the wave's inputs are kept: nothing per bounce.
        ctx.replay = replay
        ctx.save_for_backward(sample_indices, pixel_xy, pixel_valid, *leaves)
        with stats.span("replay/forward"):
            fs, st = replay.forward(FilmState(rgb_sum, weight_sum, rgb_splat), sample_indices,
                                    pixel_xy, pixel_valid)
        ctx.mark_non_differentiable(st["rays"], st["iters"])
        return fs.rgb_sum, fs.weight_sum, fs.rgb_splat, st["rays"], st["iters"]

    @staticmethod
    def backward(ctx, g_rgb, g_w, g_splat, _g_rays, _g_iters):
        sample_indices, pixel_xy, pixel_valid, *leaves = ctx.saved_tensors
        with stats.span("replay/backward"), torch.enable_grad():
            params = [leaf.detach().requires_grad_(True) for leaf in leaves]
            grads = ctx.replay.vjp(params, (g_rgb, g_w, g_splat), sample_indices, pixel_xy,
                                   pixel_valid)
        # The wave adds into the film state, so its gradient passes through.
        return (None, g_rgb, g_w, g_splat, None, None, None, *grads)


class _Replay:
    """What the replay wave closes over: the camera, film, sampler and
    options, and the scene with its gradient tensors detached (``paths``
    says where they go back in)."""

    def __init__(self, scene: Scene, paths, camera, film, sampler, max_depth, regularize,
                 spread):
        self.scene, self.paths = scene, paths
        self.camera, self.film, self.sampler = camera, film, sampler
        self.max_depth, self.regularize, self.spread = max_depth, regularize, spread
        self.opts = {"remat": True}
        if regularize:
            self.opts["regularize"] = True
        if spread:
            self.opts["pixel_spread"] = spread

    def forward(self, film_state, sample_indices, pixel_xy, pixel_valid):
        return render_wave_wavefront(
            self.scene, self.camera, self.film, self.sampler, film_state, sample_indices,
            pixel_xy, pixel_valid, max_depth=self.max_depth, regularize=self.regularize,
            pixel_spread=self.spread)

    def vjp(self, params, grads, sample_indices, pixel_xy, pixel_valid):
        """The gradients of the wave's film sums, weighted by ``grads``,
        with respect to ``params`` (the scene's gradient tensors, in
        place), through the same (pixel, sample) paths replayed by the
        megakernel.  The add is linear, so the replay adds into zeros."""
        scene = with_tensor_fields(self.scene, zip(self.paths, params))
        zero = FilmState(*(torch.zeros(g.shape, dtype=g.dtype, device=g.device) for g in grads))
        with stats.span("replay/remat"):
            fs, _ = render_pixel_samples(
                scene, self.camera, self.film, self.sampler, li_path, self.opts, zero,
                sample_indices, pixel_xy, pixel_valid=pixel_valid, max_depth=self.max_depth)
        pairs = [(out, g) for out, g in zip((fs.rgb_sum, fs.weight_sum, fs.rgb_splat), grads)
                 if out.requires_grad]
        if not pairs or not params:
            return [None] * len(params)
        outs, gs = zip(*pairs)
        with stats.span("replay/vjp"):
            return torch.autograd.grad(outs, params, gs, allow_unused=True)


def make_replay_wavefront_renderer(scene: Scene, camera, film: RgbFilm, sampler,
                                   max_depth: int = 5, regularize: bool = False,
                                   with_stats: bool = False):
    """Differentiable wavefront wave: path-replay backprop.

    Returns ``wave(scene, film_state, sample_indices, pixel_xy,
    pixel_valid) -> film_state`` (``(film_state, stats)`` with
    ``with_stats``: the wave's traced ``rays`` and loop ``iters``), a
    ``torch.autograd.Function`` differentiable with respect to the film
    state and to every tensor of ``scene`` that requires grad (material
    tables, textures, light scales, ...; nested tables included).

    The forward is the regenerating wavefront, run without a graph, and
    keeps only the wave's inputs.  The backward rebuilds the scene on
    detached copies of those tensors and replays every (pixel, sample)
    path through the megakernel (``li_path(remat=True)``, the camera's
    spread shrunk with the sample count): the counter-based sampler gives
    both integrators the same draws, so the replayed estimator equals the
    forward one and its gradient is the wave's.  ``scene`` here is the
    reference's argument and unused: the wave takes its scene per call."""
    spread = _spp_spread(camera, sampler)

    def wave(scene: Scene, film_state: FilmState, sample_indices, pixel_xy, pixel_valid):
        fields = grad_tensor_fields(scene)
        paths = [path for path, _ in fields]
        leaves = [t for _, t in fields]
        skeleton = with_tensor_fields(scene, [(path, t.detach()) for path, t in fields])
        replay = _Replay(skeleton, paths, camera, film, sampler, max_depth, regularize, spread)
        idx = torch.as_tensor(sample_indices, device=scene.device).to(torch.int64)
        rgb, w, splat, rays, iters = _ReplayWave.apply(
            replay, film_state.rgb_sum, film_state.weight_sum, film_state.rgb_splat, idx,
            pixel_xy, pixel_valid, *leaves)
        fs = FilmState(rgb_sum=rgb, weight_sum=w, rgb_splat=splat)
        return (fs, {"rays": rays, "iters": iters}) if with_stats else fs

    return wave


def pixel_blocks(film: RgbFilm, block: int, device=None):
    """Split the image into fixed-size pixel blocks (+ validity masks) on
    ``device`` (default: the CUDA card)."""
    device = resolve_device(device)
    w, h = film.resolution
    n = w * h
    block = min(block, n)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    px = np.stack([xs.reshape(-1), ys.reshape(-1)], axis=-1).astype(np.int32)
    pad = (-n) % block
    if pad:
        px = np.concatenate([px, np.zeros((pad, 2), np.int32)])
    valid = np.ones(n + pad, bool)
    valid[n:] = False
    n_blocks = (n + pad) // block
    return (
        torch.from_numpy(px.reshape(n_blocks, block, 2)).to(device),
        torch.from_numpy(valid.reshape(n_blocks, block)).to(device),
    )


def render(
    scene: Scene,
    camera,
    film: RgbFilm,
    sampler,
    integrator: str = "path",
    spp: int | None = None,
    max_depth: int = 5,
    wave_spp: int = 4,
    regularize: bool = False,
    integrator_options: dict | None = None,
    film_state: FilmState | None = None,
    progress=None,
    pixel_block: int = DEFAULT_PIXEL_BLOCK,
    disable_pixel_jitter: bool = False,
    disable_wavelength_jitter: bool = False,
    wavefront: bool | None = None,
    collect_stats: bool = False,
    checkpoint_path=None,
    checkpoint_every: int = 1,
):
    """Full render: wave x pixel-block loop on the host, the reference's
    interface (keyword names and order).

    Returns the (H, W, 3) image and the final FilmState; with
    ``collect_stats`` also a dict: the traced ``rays`` (the wavefront and
    the path megakernel count them) and the wavefront's loop ``iters``,
    summed over all waves.  Passing a FilmState as ``film_state`` resumes
    from it; ``progress(done_spp, spp)`` is called after every wave.

    ``wavefront=None`` takes the regenerating wavefront for the path
    estimator without options, and the megakernel otherwise; ``False``
    forces the megakernel, ``True`` the wavefront.

    ``checkpoint_path`` persists the film state every ``checkpoint_every``
    waves (and after the last) and resumes from a checkpoint there whose
    fingerprint matches this render; a stale one is ignored with a
    warning.  The sampler is counter-based, so a resumed render's film
    state equals an uninterrupted one's bit for bit
    (``utils/checkpoint.py``).  ``collect_stats`` also fills the
    ``utils/stats`` registry: the pixel samples, the wave time (each
    block waited for on the card) and, for the wavefront, the traced
    rays and loop iterations.  Spans are recorded either way: a
    ``render/wave`` span around each block-wave, the layers' own inside
    it."""
    dev = scene.device
    spp = spp if spp is not None else sampler.samples_per_pixel
    use_wavefront = (integrator == "path" and not integrator_options
                     if wavefront is None else wavefront)
    if use_wavefront:
        wave_fn = make_wavefront_renderer(
            scene, camera, film, sampler, max_depth=max_depth, regularize=regularize,
            disable_pixel_jitter=disable_pixel_jitter,
            disable_wavelength_jitter=disable_wavelength_jitter,
        )
    else:
        wave_fn = make_wave_renderer(
            scene, camera, film, sampler, integrator, max_depth, regularize,
            integrator_options=integrator_options, disable_pixel_jitter=disable_pixel_jitter,
            disable_wavelength_jitter=disable_wavelength_jitter,
        )
    state = film_state if film_state is not None else film.init_state(dev)
    blocks, valids = pixel_blocks(film, pixel_block, dev)
    totals = {}
    start = 0
    ckpt = None
    if checkpoint_path is not None:
        ckpt = RenderCheckpointer(checkpoint_path, fingerprint={
            "resolution": tuple(int(r) for r in film.resolution),
            "spp": int(spp),
            "max_depth": int(max_depth),
            "integrator": integrator,
            "wavefront": bool(use_wavefront),
            "seed": int(getattr(sampler, "seed", 0)),
            "wave_spp": int(wave_spp),
        })
        loaded = ckpt.load()
        if loaded is not None:
            arrays, start = loaded
            state = FilmState(**{k: f32(v, dev) for k, v in arrays.items()})
    if collect_stats:
        stats.counter("Render/Pixel samples").add(film.resolution[0] * film.resolution[1] * spp)
        wave_timer = stats.timer("Render/Wave time")
    wave_span = stats.span("render/wave")
    while start < spp:
        n = min(wave_spp, spp - start)
        idx = torch.arange(start, start + n, dtype=torch.int64, device=dev)
        for b in range(blocks.shape[0]):
            with wave_span:
                if collect_stats:
                    with wave_timer:
                        state, st = wave_fn(state, idx, blocks[b], valids[b])
                        if dev.type == "cuda":
                            torch.cuda.synchronize(dev)
                else:
                    state, st = wave_fn(state, idx, blocks[b], valids[b])
            if collect_stats:
                if use_wavefront:
                    stats.counter("Integrator/Rays traced").add(st["rays"])
                    stats.counter("Integrator/Wavefront iterations").add(st["iters"])
                for key, v in st.items():
                    if v is not None:
                        totals[key] = totals.get(key, 0.0) + v.to(torch.float64)
        start += n
        if ckpt is not None and ((start // max(wave_spp, 1)) % max(checkpoint_every, 1) == 0
                                 or start >= spp):
            ckpt.save(state, start)
        if progress is not None:
            progress(start, spp)
    image = film.get_image(state)
    if collect_stats:
        return image, state, {key: float(v) for key, v in totals.items()}
    return image, state
