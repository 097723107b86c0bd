"""Spectra, color, film and camera of the port against the reference on
random inputs made from a seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shimmer_tpu.cameras import CameraTransform as JCT, PerspectiveCamera as JCam
from shimmer_tpu.color.colorspace import get_named_color_space as jcs
from shimmer_tpu.film.film import FilmState as JFS, PixelSensor as JSensor, RgbFilm as JFilm
from shimmer_tpu.film.filters import BoxFilter as JBox
from shimmer_tpu.ops.transform import Transform as JT
from shimmer_tpu.spectra import rgb2spec as jr2s
from shimmer_tpu.spectra.sampled import SampledWavelengths as JSWL
from shimmer_tpu_torch.bench_scene import bench_camera_film
from shimmer_tpu_torch.color.colorspace import get_named_color_space as tcs
from shimmer_tpu_torch.film.film import FilmState as TFS, PixelSensor as TSensor, RgbFilm as TFilm
from shimmer_tpu_torch.film.filters import BoxFilter as TBox
from shimmer_tpu_torch.spectra import rgb2spec as tr2s
from shimmer_tpu_torch.spectra.sampled import SampledWavelengths as TSWL
from torch_parity import assert_parity

torch.set_num_threads(1)

RTOL = 1e-5  # f32 sums and transcendentals in another order than XLA's


def _radiance_and_wavelengths(seed, n=4096):
    rng = np.random.default_rng(seed)
    L = rng.exponential(2.0, (n, 4)).astype(np.float32)
    L[:16] = 0.0
    u = rng.random(n).astype(np.float32)
    return L, u


def _films(max_component_value=float("inf")):
    jf = JFilm((32, 24), JBox(), JSensor(jcs("srgb")), jcs("srgb"),
               max_component_value=max_component_value)
    tf = TFilm((32, 24), TBox(), TSensor(tcs("srgb")), tcs("srgb"),
               max_component_value=max_component_value)
    return jf, tf


def test_colorspace_matrices():
    j, t = jcs("srgb"), tcs("srgb")
    np.testing.assert_allclose(t.rgb_from_xyz, j.rgb_from_xyz, rtol=1e-12)
    np.testing.assert_allclose(t.w, j.w, rtol=1e-12)


def test_to_sensor_rgb():
    jf, tf = _films()
    L, u = _radiance_and_wavelengths(0)
    assert_parity(
        lambda L, u: jf.sensor.to_sensor_rgb(L, JSWL.sample_visible(u)),
        lambda L, u: tf.sensor.to_sensor_rgb(L, TSWL.sample_visible(u)),
        L, u, rtol=RTOL,
    )


@pytest.mark.parametrize("max_component_value", [float("inf"), 3.0])
def test_clamped_rgb(max_component_value):
    jf, tf = _films(max_component_value)
    L, u = _radiance_and_wavelengths(1)
    assert_parity(
        lambda L, u: jf._clamped_rgb(L, JSWL.sample_visible(u)),
        lambda L, u: tf._clamped_rgb(L, TSWL.sample_visible(u)),
        L, u, rtol=RTOL,
    )


def test_get_image():
    jf, tf = _films()
    rng = np.random.default_rng(2)
    rgb = rng.exponential(1.0, (24, 32, 3)).astype(np.float32)
    w = rng.integers(0, 4, (24, 32)).astype(np.float32)
    splat = rng.exponential(0.1, (24, 32, 3)).astype(np.float32)
    assert_parity(
        lambda a, b, c: jf.get_image(JFS(rgb_sum=a, weight_sum=b, rgb_splat=c)),
        lambda a, b, c: tf.get_image(TFS(rgb_sum=a, weight_sum=b, rgb_splat=c)),
        rgb, w, splat, rtol=RTOL, atol=1e-6,
    )


def test_rgb_fit_and_sigmoid_spectrum():
    rng = np.random.default_rng(3)
    rgb = rng.random((24, 3))
    rgb[0] = [0.0, 0.0, 0.0]
    rgb[1] = [0.55, 0.45, 0.35]
    cj = jr2s.fit_rgb_coeffs(rgb, jcs("srgb"))
    ct = tr2s.fit_rgb_coeffs(rgb, tcs("srgb"))
    np.testing.assert_allclose(ct, cj, rtol=RTOL, atol=1e-6)
    lam = rng.uniform(360.0, 830.0, (24, 4)).astype(np.float32)
    assert_parity(jr2s.sigmoid_poly_sample, tr2s.sigmoid_poly_sample, cj, lam, rtol=RTOL)


def test_bench_camera_generate_ray():
    """The bench camera of bench.py (look-at, 40 degree fov, 1280x720)."""
    ct = JCT(JT.look_at(jnp.array([0.0, 0.6, -3.2]), jnp.array([0.0, 0.0, 0.0]),
                        jnp.array([0.0, 1.0, 0.0])))
    jcam = JCam(ct, (1280, 720), fov=40.0)
    tcam, _ = bench_camera_film((1280, 720))
    np.testing.assert_array_equal(
        tcam.camera_transform.render_from_camera.m,
        np.asarray(jcam.camera_transform.render_from_camera.m),
    )
    rng = np.random.default_rng(4)
    p_film = (rng.random((8192, 2)) * [1280.0, 720.0]).astype(np.float32)
    p_film[:4] = [[0.0, 0.0], [1280.0, 720.0], [640.0, 360.0], [0.5, 719.5]]
    u_lens = rng.random((8192, 2)).astype(np.float32)

    def jax_fn(p, u):
        r = jcam.generate_ray(p, u)
        return r.o, r.d

    def torch_fn(p, u):
        r = tcam.generate_ray(p, u)
        return r.o, r.d

    # XLA contracts the 4x4 transform as a dot; the port spells the sum out.
    assert_parity(jax_fn, torch_fn, p_film, u_lens, rtol=1e-6, atol=1e-7)
