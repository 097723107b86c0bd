"""Render orchestration (port of ``shimmer_tpu/render.py``: ``render`` with
the reference's interface over its wavefront branch,
``make_wavefront_renderer`` and ``pixel_blocks``).

The image is split into fixed-size pixel blocks; each wave renders
``wave_spp`` sample indices of one block with the regenerating wavefront
and scatter-adds into the film state.
"""

from __future__ import annotations

import numpy as np
import torch

from shimmer_tpu_torch.config import resolve_device
from shimmer_tpu_torch.film.film import FilmState, RgbFilm
from shimmer_tpu_torch.integrators.wavefront import render_wave_wavefront
from shimmer_tpu_torch.scene import Scene

DEFAULT_PIXEL_BLOCK = 1 << 15


def make_wavefront_renderer(scene: Scene, camera, film: RgbFilm, sampler,
                            max_depth: int = 5):
    """Wave function (film_state, sample_indices, pixel_xy, pixel_valid)
    -> (film_state, stats); stats['rays'] is the exact traced ray count of
    the wave and stats['iters'] its loop iterations.  The camera's pixel
    spread, shrunk with the sample count, sizes the texture footprints."""
    spread = getattr(camera, "pixel_spread", 0.0)
    if spread:
        spread = spread * max(0.125, 1.0 / np.sqrt(max(sampler.samples_per_pixel, 1)))

    def render_samples(film_state, sample_indices, pixel_xy, pixel_valid):
        return render_wave_wavefront(
            scene, camera, film, sampler, film_state, sample_indices,
            pixel_xy, pixel_valid, max_depth=max_depth, pixel_spread=spread,
        )

    return render_samples


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
    ``collect_stats`` also a dict with the traced ``rays`` and the loop
    ``iters`` summed over all waves.  Passing a FilmState as
    ``film_state`` resumes from it; ``progress(done_spp, spp)`` is called
    after every wave.  Only the wavefront path integrator is ported:
    another integrator, ``wavefront=False``, ``integrator_options``,
    ``regularize``, either jitter switch and ``checkpoint_path`` raise
    NotImplementedError."""
    unported = {
        f"integrator {integrator!r}": integrator != "path",
        "wavefront=False (the megakernel)": wavefront is False,
        "integrator_options": bool(integrator_options),
        "regularize=True": regularize,
        "disable_pixel_jitter": disable_pixel_jitter,
        "disable_wavelength_jitter": disable_wavelength_jitter,
        "checkpoint_path (render checkpoints)": checkpoint_path is not None,
    }
    for what, asked in unported.items():
        if asked:
            raise NotImplementedError(f"render: {what} is not ported yet")
    dev = scene.device
    spp = spp if spp is not None else sampler.samples_per_pixel
    wave_fn = make_wavefront_renderer(scene, camera, film, sampler, max_depth=max_depth)
    state = film_state if film_state is not None else film.init_state(dev)
    blocks, valids = pixel_blocks(film, pixel_block, dev)
    rays = torch.zeros((), device=dev)
    iters = torch.zeros((), device=dev)
    start = 0
    while start < spp:
        n = min(wave_spp, spp - start)
        idx = torch.arange(start, start + n, dtype=torch.int64, device=dev)
        for b in range(blocks.shape[0]):
            state, st = wave_fn(state, idx, blocks[b], valids[b])
            rays = rays + st["rays"]
            iters = iters + st["iters"]
        start += n
        if progress is not None:
            progress(start, spp)
    image = film.get_image(state)
    if collect_stats:
        return image, state, {"rays": float(rays), "iters": float(iters)}
    return image, state
