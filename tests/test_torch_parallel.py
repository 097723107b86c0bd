"""Sharded rendering in the port (shimmer_tpu_torch/parallel/render.py)
over 8 CPU bands, the port of tests/test_parallel.py: tiles and spp mode
against the port's unsharded render (spp mode over two waves), the film
height check, the band-local film scatter of the wavefront and of
``RgbFilm.add_samples``, the port's sharded image against the
reference's ``render_sharded`` on 8 virtual devices (the image-agreement
gate), the reference's spp-mode film weight after two waves beside the
port's, the replay wavefront's gradient by band against the whole
image's, and the sharded training step's gradient against one band's."""

import os

os.environ.setdefault("OMP_NUM_THREADS", "1")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shimmer_tpu.parallel.render import make_tile_mesh as jax_tile_mesh
from shimmer_tpu.parallel.render import render_sharded as jax_render_sharded
from shimmer_tpu.samplers import IndependentSampler as JaxIndependent
from shimmer_tpu_torch.flagship import dryrun_multichip, reflectance_grad
from shimmer_tpu_torch.integrators.wavefront import render_wave_wavefront
from shimmer_tpu_torch.parallel.render import (LocalBandFilm, init_sharded_film_state,
                                               make_tile_mesh, render_sharded)
from shimmer_tpu_torch.render import (band_pixels, full_image_pixels,
                                      make_replay_wavefront_renderer, render)
from shimmer_tpu_torch.samplers import IndependentSampler
from torch_grad import (_sphere_and_light, jax_camera, jax_film, port_camera, port_film,
                        port_scene, replace)

torch.set_num_threads(1)

RES, DEPTH, BANDS = 32, 3, 8
# The image-agreement gate (PERF.md section 2).
PIXEL_RTOL, PIXEL_ATOL, PIXEL_FRAC = 1e-3, 1e-4, 0.99


@pytest.fixture(scope="module")
def setup():
    """tests/test_parallel.py's scene, in both packages."""
    jcam = jax_camera(RES)
    jscene = _sphere_and_light([0.8, 0.4, 0.2], 40.0, 1.0, jcam.camera_transform.render_from_world())
    return (jscene, jcam, jax_film(RES)), (port_scene(jscene), port_camera(jcam), port_film(RES))


def bands(n=BANDS):
    return make_tile_mesh(["cpu"] * n)


@pytest.mark.parametrize("wavefront", [None, False], ids=["wavefront", "megakernel"])
def test_tile_sharding_matches_render(setup, wavefront):
    scene, cam, film = setup[1]
    spp = 16
    ref, _ = render(scene, cam, film, IndependentSampler(spp), spp=spp, max_depth=DEPTH,
                    wave_spp=8, wavefront=wavefront)
    img, states = render_sharded(scene, cam, film, IndependentSampler(spp), bands(), spp=spp,
                                 max_depth=DEPTH, wave_spp=8, mode="tiles", wavefront=wavefront)
    assert len(states) == BANDS and states[0].rgb_sum.shape == (RES // BANDS, RES, 3)
    np.testing.assert_allclose(img.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("wavefront", [None, False], ids=["wavefront", "megakernel"])
def test_spp_sharding_matches_render_over_two_waves(setup, wavefront):
    scene, cam, film = setup[1]
    spp = 32
    ref, _ = render(scene, cam, film, IndependentSampler(spp), spp=spp, max_depth=DEPTH,
                    wave_spp=spp, wavefront=wavefront)
    seen = []
    img, state = render_sharded(scene, cam, film, IndependentSampler(spp), bands(), spp=spp,
                                max_depth=DEPTH, wave_spp=2, mode="spp", wavefront=wavefront,
                                progress=lambda done, total: seen.append(done))
    assert seen == [16, 32]  # two waves of 2 samples a device
    # Every sample counted once (box filter: weight 1 a sample).
    assert float(state.weight_sum.sum()) == spp * RES * RES
    np.testing.assert_allclose(img.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


def test_spp_mode_rounds_a_wave_up_to_the_devices(setup):
    """As the reference: a wave is cut to a multiple of the device count
    and to at least one sample a device, so 4 spp over 8 devices renders
    8."""
    scene, cam, film = setup[1]
    _, state = render_sharded(scene, cam, film, IndependentSampler(4), bands(), spp=4,
                              max_depth=1, mode="spp")
    assert float(state.weight_sum.sum()) == 8 * RES * RES


@pytest.mark.parametrize("mode", ["tiles", "spp"])
def test_height_not_divisible_raises(setup, mode):
    scene, cam, film = setup[1]
    with pytest.raises(ValueError, match="not divisible by 3 devices"):
        render_sharded(scene, cam, film, IndependentSampler(1), bands(3), spp=1, mode=mode)


def test_mesh_needs_devices_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make_tile_mesh()
    mesh = make_tile_mesh(["cpu", "cpu"])
    assert mesh.devices == (torch.device("cpu"),) * 2 and mesh.n_shards == 2


def test_wavefront_scatters_band_local(setup):
    """A band's wavefront wave adds into a (rows, W) state at band-local
    rows, its padded lanes dropped; the band equals those rows of the
    whole image's wave."""
    scene, cam, film = setup[1]
    sampler, idx = IndependentSampler(2), torch.arange(2)
    whole, _ = render_wave_wavefront(scene, cam, film, sampler, film.init_state("cpu"), idx,
                                     full_image_pixels(film, "cpu"), None, max_depth=DEPTH)
    row0, rows = 12, 4
    px = band_pixels(film, row0, rows, "cpu")
    pad = 5  # padded lanes, as pixel_blocks makes them: pixel (0, 0), not valid
    px = torch.cat([px, torch.zeros((pad, 2), dtype=px.dtype)])
    valid = torch.arange(px.shape[0]) < px.shape[0] - pad
    band = init_sharded_film_state(film, make_tile_mesh(["cpu"] * (RES // rows)))[0]
    out, _ = render_wave_wavefront(scene, cam, LocalBandFilm(film, row0), sampler, band, idx, px,
                                   valid, max_depth=DEPTH)
    assert out.rgb_sum.shape == (rows, RES, 3)
    for name in ("rgb_sum", "weight_sum"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   getattr(whole, name)[row0:row0 + rows].numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_add_samples_takes_rows_from_the_state(setup):
    """RgbFilm.add_samples into a (rows, W) band state: each lane at its
    band-local row, lanes outside the band dropped."""
    _, _, film = setup[1]
    gen = torch.Generator().manual_seed(3)
    rows, row0 = 4, 8
    px = torch.stack([torch.randint(0, RES, (RES,), generator=gen),
                      torch.arange(RES) % (rows + 4) + row0 - 2], dim=-1).to(torch.int32)
    # Distinct pixels, as add_samples asks.
    px[:, 0] = torch.arange(RES, dtype=torch.int32)
    radiance = torch.rand((RES, 4), generator=gen)
    swl = film.sample_wavelengths(torch.rand(RES, generator=gen))
    weight = torch.rand(RES, generator=gen)
    whole = film.add_samples(film.init_state("cpu"), px, radiance, swl, weight)
    band = init_sharded_film_state(film, make_tile_mesh(["cpu"] * (RES // rows)))[0]
    out = LocalBandFilm(film, row0).add_samples(band, px, radiance, swl, weight)
    assert torch.equal(out.rgb_sum, whole.rgb_sum[row0:row0 + rows])
    assert torch.equal(out.weight_sum, whole.weight_sum[row0:row0 + rows])
    inside = (px[:, 1] >= row0) & (px[:, 1] < row0 + rows)
    assert 0 < int(inside.sum()) < RES
    assert float(out.weight_sum.sum()) == pytest.approx(float(weight[inside].sum()), rel=1e-6)


def test_replay_gradient_over_bands_matches_the_whole_image(setup):
    """The replay wavefront wave by band (LocalBandFilm, band-local
    states): the bands' summed loss has the whole image's gradient."""
    scene, cam, film = setup[1]
    sampler, idx = IndependentSampler(2), torch.arange(2)
    rows = RES // BANDS

    def loss_grad(per_band):
        refl = scene.materials.reflectance.clone().requires_grad_(True)
        sc = replace(scene, "materials", reflectance=refl)
        if per_band:
            states = init_sharded_film_state(film, bands())
            loss = sum(
                make_replay_wavefront_renderer(sc, cam, LocalBandFilm(film, i * rows), sampler,
                                               max_depth=DEPTH)(
                    sc, states[i], idx, band_pixels(film, i * rows, rows, "cpu"), None
                ).rgb_sum.sum()
                for i in range(BANDS))
        else:
            replay = make_replay_wavefront_renderer(sc, cam, film, sampler, max_depth=DEPTH)
            loss = replay(sc, film.init_state("cpu"), idx, full_image_pixels(film, "cpu"),
                          None).rgb_sum.sum()
        (g,) = torch.autograd.grad(loss, refl)
        return float(loss.detach()), g

    v_bands, g_bands = loss_grad(True)
    v_whole, g_whole = loss_grad(False)
    np.testing.assert_allclose(v_bands, v_whole, rtol=1e-5)
    np.testing.assert_allclose(g_bands.numpy(), g_whole.numpy(), rtol=1e-5,
                               atol=1e-6 * float(g_whole.abs().max()))
    assert float(g_whole.abs().max()) > 0


def _agreement(a, b):
    close = np.isclose(a, b, rtol=PIXEL_RTOL, atol=PIXEL_ATOL).all(axis=-1)
    return float(close.mean())


@pytest.mark.parametrize("mode,spp,wave_spp", [("tiles", 16, 8), ("spp", 32, 4)])
def test_sharded_image_matches_reference(setup, mode, spp, wave_spp):
    """The port's sharded image against the reference's on 8 virtual
    devices, at tests/test_parallel.py's settings (spp mode in one wave,
    where the reference's reduction is right)."""
    (jscene, jcam, jfilm), (scene, cam, film) = setup
    ref, _ = jax_render_sharded(jscene, jcam, jfilm, JaxIndependent(spp), jax_tile_mesh(), "path",
                                spp=spp, max_depth=DEPTH, wave_spp=wave_spp, mode=mode)
    img, _ = render_sharded(scene, cam, film, IndependentSampler(spp), bands(), spp=spp,
                            max_depth=DEPTH, wave_spp=wave_spp, mode=mode)
    ref, img = np.asarray(ref), img.numpy()
    assert _agreement(img, ref) >= PIXEL_FRAC
    assert abs(img.mean() - ref.mean()) <= 1e-3 * abs(ref.mean())


def test_reference_spp_weight_after_two_waves(setup):
    """Two spp-mode waves of 32 samples: the reference psums each
    device's running state with its samples, so the first wave's weight
    counts once per device more; the port counts every sample once."""
    (jscene, jcam, jfilm), (scene, cam, film) = setup
    spp, wave_spp = 64, 4
    _, jstate = jax_render_sharded(jscene, jcam, jfilm, JaxIndependent(spp), jax_tile_mesh(),
                                   "path", spp=spp, max_depth=DEPTH, wave_spp=wave_spp,
                                   mode="spp")
    _, state = render_sharded(scene, cam, film, IndependentSampler(spp), bands(), spp=spp,
                              max_depth=DEPTH, wave_spp=wave_spp, mode="spp")
    wave = BANDS * wave_spp * RES * RES  # one wave's weight
    reference, port = float(jnp.sum(jstate.weight_sum)), float(state.weight_sum.sum())
    assert (reference, port) == ((BANDS + 1) * wave, 2 * wave)  # 294,912 against 65,536


def test_dryrun_gradient_matches_one_band():
    res = (16, 8 * BANDS)
    loss8, g8 = reflectance_grad(bands(), res)
    loss1, g1 = reflectance_grad(bands(1), res)
    np.testing.assert_allclose(float(loss8), float(loss1), rtol=1e-5)
    np.testing.assert_allclose(g8.numpy(), g1.numpy(), rtol=1e-5, atol=1e-5 * float(g1.abs().max()))
    out = dryrun_multichip(["cpu"] * BANDS)
    np.testing.assert_allclose(out["grad"], g8.numpy(), rtol=1e-5, atol=1e-6)
    assert out["wave_image_mean"] > 0
