"""tests/test_film_precision.py's four cases in the port, on the CPU, at
that file's sizes and limits: the float32 film against a float64 oracle
over 1,024 waves and over an HDR stream spanning 6 decades, and the two
splat cases (energy of a Gaussian r = 1.5 footprint, edge clipping)."""

import os

os.environ.setdefault("OMP_NUM_THREADS", "1")

import numpy as np
import torch

from shimmer_tpu_torch.color.colorspace import get_named_color_space
from shimmer_tpu_torch.film.film import PixelSensor, RgbFilm
from shimmer_tpu_torch.film.filters import BoxFilter, GaussianFilter
from shimmer_tpu_torch.spectra.sampled import SampledWavelengths

torch.set_num_threads(1)


def _film(res=8):
    cs = get_named_color_space("srgb")
    return RgbFilm((res, res), BoxFilter(), PixelSensor(cs), cs)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def test_1024_wave_accumulation_matches_f64():
    film = _film()
    w, h = film.resolution
    n = w * h
    rng = np.random.default_rng(0)
    state = film.init_state("cpu")
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    pixel_xy = torch.from_numpy(np.stack([xs.ravel(), ys.ravel()], axis=-1).astype(np.int32))
    rgb64 = np.zeros((h, w, 3), np.float64)
    w64 = np.zeros((h, w), np.float64)
    for wave in range(0, 1024, 64):
        for _ in range(64):
            L = _t(rng.lognormal(0.0, 1.5, (n, 4)))
            u = _t(rng.uniform(size=(n,)))
            swl = SampledWavelengths.sample_visible(u)
            weight = _t(rng.uniform(0.2, 1.8, (n,)))
            state = film.add_samples(state, pixel_xy, L, swl, weight)
            contrib = (film._clamped_rgb(L, swl) * weight[..., None]).numpy().astype(np.float64)
            rgb64[ys.ravel(), xs.ravel()] += contrib
            w64[ys.ravel(), xs.ravel()] += weight.numpy().astype(np.float64)
        if wave == 0:
            assert float(state.weight_sum.min()) > 0.0
    img32 = state.rgb_sum.numpy().astype(np.float64) / state.weight_sum.numpy().astype(
        np.float64)[..., None]
    img64 = rgb64 / w64[..., None]
    rel = np.abs(img32 - img64) / np.maximum(np.abs(img64), 1e-3)
    assert rel.max() < 1e-4, f"f32 film accumulation error {rel.max():.2e}"


def test_hdr_stream_accumulation():
    film = _film(res=2)
    state = film.init_state("cpu")
    rng = np.random.default_rng(1)
    pixel_xy = torch.tensor([[0, 0]], dtype=torch.int32)
    total = np.zeros(3, np.float64)
    for _ in range(512):
        mag = 10.0 ** rng.uniform(-3, 3)
        L = _t(rng.uniform(0.5, 1.5, (1, 4)) * mag)
        swl = SampledWavelengths.sample_visible(_t([rng.uniform()]))
        state = film.add_samples(state, pixel_xy, L, swl, torch.ones(1))
        total += film._clamped_rgb(L, swl).numpy().astype(np.float64)[0]
    got = state.rgb_sum.numpy().astype(np.float64)[0, 0]
    rel = np.abs(got - total) / np.maximum(np.abs(total), 1e-12)
    assert rel.max() < 1e-3, f"HDR f32 accumulation error {rel.max():.2e}"


def test_splat_energy_conserved_wide_filter():
    cs = get_named_color_space("srgb")
    filt = GaussianFilter(1.5, 1.5, 0.6)
    film = RgbFilm((32, 32), filt, PixelSensor(cs), cs)
    n = 256
    rng = np.random.default_rng(0)
    p = _t(rng.uniform(4.0, 28.0, (n, 2)))
    swl = SampledWavelengths.sample_uniform(torch.full((n,), 0.5))
    lrad = torch.ones((n, 4))
    state = film.add_splats(film.init_state("cpu"), p, lrad, swl)
    total = float(state.rgb_splat.sum())
    p_np = p.numpy()
    want = 0.0
    rgb1 = film._clamped_rgb(lrad, swl).numpy()
    for i in range(n):
        x0 = int(np.ceil(p_np[i, 0] - 0.5 - 1.5))
        y0 = int(np.ceil(p_np[i, 1] - 0.5 - 1.5))
        fw = 0.0
        for dy in range(4):
            for dx in range(4):
                off = np.array([x0 + dx + 0.5 - p_np[i, 0], y0 + dy + 0.5 - p_np[i, 1]],
                               np.float32)
                fw += float(filt.evaluate(torch.from_numpy(off[None]))[0])
        want += fw * rgb1[i].sum()
    np.testing.assert_allclose(total, want, rtol=1e-4)


def test_splat_edge_clipping():
    cs = get_named_color_space("srgb")
    film = RgbFilm((16, 16), GaussianFilter(1.5, 1.5, 0.6), PixelSensor(cs), cs)
    p = _t([[0.2, 0.2], [15.8, 15.8]])
    swl = SampledWavelengths.sample_uniform(torch.full((2,), 0.5))
    state = film.add_splats(state=film.init_state("cpu"), p_film=p, L=torch.ones((2, 4)),
                            swl=swl)
    a = state.rgb_splat.numpy()
    assert np.isfinite(a).all() and (a >= 0).all()
    interior = film.add_splats(film.init_state("cpu"), _t([[8.0, 8.0]]), torch.ones((1, 4)),
                               SampledWavelengths.sample_uniform(torch.full((1,), 0.5)))
    assert a[:4, :4].sum() < interior.rgb_splat.numpy().sum()
