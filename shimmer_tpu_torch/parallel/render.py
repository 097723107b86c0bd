"""Sharded rendering over several devices in one process (port of
``shimmer_tpu/parallel/render.py``).

A mesh is a list of devices, one per shard; a device may be listed more
than once (two bands on one card, or several CPU "devices").  Each
distinct device gets one replica of the scene (``Scene.to``, which
autograd differentiates), and the shards render in turn, the semantics of
the reference's ``shard_map``, each with its card the current device:
the hand-written kernels launch on the current stream of their tensors'
card, which CUDA runs only on the current device.

``mode="tiles"``: the film's rows are split into equal bands, one a
shard.  Camera rays and sampler seeds take global pixel coordinates; the
film scatter takes band-local rows (``LocalBandFilm``), and each band
adds into a ``(rows_per, W)`` state of its own.  No shard reads another's
state, so there is nothing to reduce.

``mode="spp"``: every shard renders the whole image for its slice of the
wave's sample indices into a zero state; the states are summed in device
order on the first device, and the sum is added to the running state.
So a render of any number of waves sums every sample once.  (The
reference adds each shard's running state into its psum, which counts
every earlier wave once per device from the second wave on; the port
does not copy that.)

In both modes each shard's render is a ``shard/band`` span, and each adds
1 to the counter ``Shard/Band waves``.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from shimmer_tpu_torch.film.film import FilmState, RgbFilm
from shimmer_tpu_torch.integrators.wavefront import render_wave_wavefront
from shimmer_tpu_torch.render import (INTEGRATORS, _megakernel_opts, _spp_spread, band_pixels,
                                      full_image_pixels, render_pixel_samples)
from shimmer_tpu_torch.utils import stats


@dataclasses.dataclass(frozen=True)
class TileMesh:
    """The shards of a sharded render: ``devices`` are this process's,
    in band order; in a job of ``process_count`` processes, process ``r``
    owns bands ``r * len(devices)`` to ``(r + 1) * len(devices) - 1``
    (``distributed.global_mesh``)."""

    devices: tuple
    axis: str = "tiles"
    process_index: int = 0
    process_count: int = 1

    @property
    def n_shards(self) -> int:
        """Shards over the whole job."""
        return len(self.devices) * self.process_count

    @property
    def first_shard(self) -> int:
        """The global index of this process's first shard."""
        return self.process_index * len(self.devices)


def make_tile_mesh(devices=None, axis: str = "tiles") -> TileMesh:
    """A mesh over ``devices`` (default: every local CUDA card; without a
    card ``devices`` must be given)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_tile_mesh: no CUDA card is available; pass the devices "
                               '(for example ["cpu"] * 8) to shard on the CPU')
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("make_tile_mesh: no devices")
    return TileMesh(devices, axis)


class LocalBandFilm:
    """Film view of one row band: the scatter indices are band-local rows
    (``local_xy``); everything else is the whole film's."""

    def __init__(self, film: RgbFilm, band_row0: int):
        self._film = film
        self._band = band_row0

    def __getattr__(self, name):
        return getattr(self._film, name)

    def local_xy(self, pixel_xy):
        return torch.stack([pixel_xy[..., 0], pixel_xy[..., 1] - self._band], dim=-1)

    def add_samples(self, state, pixel_xy, L, swl, weight):
        return self._film.add_samples(state, self.local_xy(pixel_xy), L, swl, weight)


def _rows_per(film: RgbFilm, mesh: TileMesh) -> int:
    h = film.resolution[1]
    if h % mesh.n_shards:
        raise ValueError(f"film height {h} not divisible by {mesh.n_shards} devices")
    return h // mesh.n_shards


def init_sharded_film_state(film: RgbFilm, mesh: TileMesh) -> list[FilmState]:
    """One zeroed ``(rows_per, W)`` band state per device of ``mesh``."""
    rows = _rows_per(film, mesh)
    w = film.resolution[0]
    return [FilmState(rgb_sum=torch.zeros((rows, w, 3), device=d),
                      weight_sum=torch.zeros((rows, w), device=d),
                      rgb_splat=torch.zeros((rows, w, 3), device=d)) for d in mesh.devices]


def make_sharded_wave_renderer(scene, camera, film: RgbFilm, sampler, mesh: TileMesh,
                               integrator: str = "path", max_depth: int = 5,
                               mode: str = "tiles", integrator_options: dict | None = None,
                               wavefront: bool | None = None,
                               disable_pixel_jitter: bool = False,
                               disable_wavelength_jitter: bool = False):
    """The sharded wave function ``(state, sample_indices) -> (state,
    stats)``; stats sums the shards' traced ``rays`` and (wavefront)
    ``iters``.

    ``mode="tiles"``: ``state`` is ``init_sharded_film_state``'s list of
    band states and ``sample_indices`` the wave's (n,) indices.
    ``mode="spp"``: ``state`` is one whole-image FilmState on the first
    device and ``sample_indices`` (n_devices, k), row d device d's slice.
    ``wavefront=None`` takes the regenerating wavefront for the path
    estimator without options, and the megakernel otherwise."""
    if mode not in ("tiles", "spp"):
        raise ValueError(f"unknown mode: {mode}")
    if mode == "spp" and mesh.process_count != 1:
        raise ValueError("spp mode shards over the devices of one process")
    use_wavefront = (integrator == "path" and not integrator_options
                     if wavefront is None else wavefront)
    rows = _rows_per(film, mesh)
    replicas = {}
    for d in mesh.devices:
        if d not in replicas:
            replicas[d] = scene.to(d)
    spread = _spp_spread(camera, sampler)
    li_fn = INTEGRATORS[integrator]
    opts = _megakernel_opts(integrator, False, integrator_options, camera, sampler)
    jitter = dict(disable_pixel_jitter=disable_pixel_jitter,
                  disable_wavelength_jitter=disable_wavelength_jitter)

    def render_shard(dev, shard_film, state, sample_indices, pixel_xy):
        idx = torch.as_tensor(sample_indices, device=dev).to(torch.int64)
        with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
            if use_wavefront:
                return render_wave_wavefront(replicas[dev], camera, shard_film, sampler, state,
                                             idx, pixel_xy, None, max_depth=max_depth,
                                             pixel_spread=spread, **jitter)
            fs, rays = render_pixel_samples(replicas[dev], camera, shard_film, sampler, li_fn,
                                            opts, state, idx, pixel_xy, max_depth=max_depth,
                                            **jitter)
        return fs, {"rays": rays}

    def add_stats(total, st):
        for key, v in st.items():
            if v is not None:
                total[key] = total.get(key, 0.0) + v.to(torch.float64).cpu()
        return total

    band_span = stats.span("shard/band")

    if mode == "tiles":
        def wave(states, sample_indices):
            out, totals = [], {}
            for i, dev in enumerate(mesh.devices):
                row0 = (mesh.first_shard + i) * rows
                with band_span:
                    fs, st = render_shard(dev, LocalBandFilm(film, row0), states[i],
                                          sample_indices, band_pixels(film, row0, rows, dev))
                    totals = add_stats(totals, st)
                stats.counter("Shard/Band waves").add(1)
                out.append(fs)
            return out, totals

        return wave

    first = mesh.devices[0]

    def wave(state, sample_indices):
        total, totals = None, {}
        for i, dev in enumerate(mesh.devices):
            with band_span:
                fs, st = render_shard(dev, film, film.init_state(dev), sample_indices[i],
                                      full_image_pixels(film, dev))
                totals = add_stats(totals, st)
            stats.counter("Shard/Band waves").add(1)
            fs = FilmState(*(t.to(first) for t in (fs.rgb_sum, fs.weight_sum, fs.rgb_splat)))
            total = fs if total is None else film.merge(total, fs)
        return film.merge(state, total), totals

    return wave


def render_sharded(scene, camera, film: RgbFilm, sampler, mesh: TileMesh | None = None,
                   integrator: str = "path", spp: int | None = None, max_depth: int = 5,
                   wave_spp: int = 4, mode: str = "tiles",
                   integrator_options: dict | None = None, wavefront: bool | None = None,
                   disable_pixel_jitter: bool = False, disable_wavelength_jitter: bool = False,
                   collect_stats: bool = False, progress=None):
    """Sharded render loop; the contract of ``render.render``: returns
    the (H, W, 3) image on the first device and the final state (tiles:
    the list of band states; spp: one FilmState), with ``collect_stats``
    also the summed ``rays`` and ``iters``; ``progress(done_spp, spp)``
    after every wave.  The image is the bands resolved and concatenated
    (in a job of several processes, this process's bands:
    ``distributed.render_multihost`` gathers the rest).

    spp mode cuts each wave to a multiple of the device count, and to at
    least one sample a device, as the reference does: an spp that is not
    a multiple may render a sample more."""
    mesh = mesh or make_tile_mesh()
    spp = spp if spp is not None else sampler.samples_per_pixel
    wave = make_sharded_wave_renderer(
        scene, camera, film, sampler, mesh, integrator, max_depth, mode, integrator_options,
        wavefront=wavefront, disable_pixel_jitter=disable_pixel_jitter,
        disable_wavelength_jitter=disable_wavelength_jitter)
    n_dev = len(mesh.devices)
    first = mesh.devices[0]
    totals = {}
    start = 0
    if mode == "tiles":
        state = init_sharded_film_state(film, mesh)
    else:
        state = film.init_state(first)
    while start < spp:
        if mode == "tiles":
            n = min(wave_spp, spp - start)
            idx = torch.arange(start, start + n, dtype=torch.int64)
        else:
            n = min(wave_spp * n_dev, spp - start)
            n = max(n_dev, (n // n_dev) * n_dev)
            idx = torch.arange(start, start + n, dtype=torch.int64).reshape(n_dev, -1)
        state, st = wave(state, idx)
        for key, v in st.items():
            totals[key] = totals.get(key, 0.0) + v
        start += n
        if progress is not None:
            progress(min(start, spp), spp)
    if mode == "tiles":
        image = torch.cat([film.get_image(s).to(first) for s in state], dim=0)
    else:
        image = film.get_image(state)
    if collect_stats:
        return image, state, {key: float(v) for key, v in totals.items()}
    return image, state
