"""Color of the port against the reference, on the CPU: the transfer
encodings (numpy and torch inputs), white balance, the four named color
spaces' matrices and white points, the D illuminant and the swatch
reflectances, ``PixelSensor.create`` (ISO, white balance, the CIE 1931
sensor and an unknown sensor) and the sensor fitted to an RGB response,
``to_sensor_rgb``, ``cie_xyz_sample`` and ``planck_device``.

Host math is float64 numpy in both packages, so matrices and spectra are
equal to the last bit; ``to_sensor_rgb`` is equal bit for bit; the
device Planck (expm1) within rtol 2e-6."""

import os

os.environ.setdefault("OMP_NUM_THREADS", "1")

import numpy as np
import pytest
import torch

from shimmer_tpu.color import color as jcolor
from shimmer_tpu.color.colorspace import get_named_color_space as jax_space
from shimmer_tpu.film.film import PixelSensor as JaxSensor
from shimmer_tpu.spectra import sampled as jsampled
from shimmer_tpu.spectra import spectrum as jspec
from shimmer_tpu_torch.color import color as tcolor
from shimmer_tpu_torch.color.colorspace import get_named_color_space as torch_space
from shimmer_tpu_torch.film.film import PixelSensor as TorchSensor
from shimmer_tpu_torch.spectra import sampled as tsampled
from shimmer_tpu_torch.spectra import spectrum as tspec
from torch_parity import assert_parity

torch.set_num_threads(1)

SPACES = ["srgb", "rec2020", "aces2065-1", "dci-p3"]


@pytest.mark.parametrize("fn", ["srgb_to_linear", "linear_to_srgb"])
def test_srgb_encodings(fn):
    v = np.random.default_rng(0).uniform(-0.05, 1.1, 5000)
    want = getattr(jcolor, fn)(v)
    np.testing.assert_array_equal(getattr(tcolor, fn)(v), want)
    v32 = v.astype(np.float32)
    assert_parity(lambda x: getattr(jcolor, fn)(x), lambda x: getattr(tcolor, fn)(x), v32,
                  rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("encoding", ["linear", "sRGB", "gamma 2.2"])
def test_color_encoding(encoding):
    j, t = jcolor.ColorEncoding.from_str(encoding), tcolor.ColorEncoding.from_str(encoding)
    assert (t.kind, t.gamma) == (j.kind, j.gamma)
    assert t == tcolor.ColorEncoding.from_str(encoding) and hash(t) == hash((j.kind, j.gamma))
    v = np.random.default_rng(1).uniform(0, 1, 1000)
    np.testing.assert_array_equal(t.to_linear(v), j.to_linear(v))
    np.testing.assert_array_equal(t.from_linear(v), j.from_linear(v))
    with pytest.raises(ValueError):
        tcolor.ColorEncoding.from_str("log")


def test_white_balance_and_chromaticity():
    src, dst = (0.3457, 0.3585), (0.3127, 0.3290)
    np.testing.assert_array_equal(tcolor.white_balance(src, dst), jcolor.white_balance(src, dst))
    np.testing.assert_array_equal(tcolor.xyz_from_xy_y(src, 2.0), jcolor.xyz_from_xy_y(src, 2.0))


@pytest.mark.parametrize("name", SPACES)
def test_color_space_matrices(name):
    j, t = jax_space(name), torch_space(name)
    assert t.name == j.name
    for attr in ("r", "g", "b", "w", "xyz_from_rgb", "rgb_from_xyz"):
        np.testing.assert_array_equal(getattr(t, attr), getattr(j, attr), err_msg=attr)
    np.testing.assert_array_equal(t.illuminant.to_dense(), j.illuminant.to_dense())
    rgb = np.array([0.2, 0.5, 0.8])
    np.testing.assert_array_equal(t.to_xyz(rgb), j.to_xyz(rgb))
    np.testing.assert_array_equal(t.to_rgb(t.to_xyz(rgb)), j.to_rgb(j.to_xyz(rgb)))


def test_unknown_color_space_raises_value_error():
    with pytest.raises(ValueError, match="unknown color space"):
        torch_space("prophoto")
    with pytest.raises(ValueError):
        jax_space("prophoto")


@pytest.mark.parametrize("temperature", [2700.0, 5000.0, 6500.0, 9000.0])
def test_d_illuminant(temperature):
    np.testing.assert_array_equal(tspec.d_illuminant(temperature).to_dense(),
                                  jspec.d_illuminant(temperature).to_dense())


def test_swatch_reflectances():
    a, b = tspec.swatch_reflectances(), jspec.swatch_reflectances()
    assert len(a) == len(b) == 24
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.to_dense(), y.to_dense())


SENSORS = {
    "default": {},
    "iso": {"iso": 400.0, "exposure_time": 0.5},
    "white_balance": {"white_balance_temp": 5000.0},
    "iso_white_balance": {"iso": 200.0, "white_balance_temp": 3200.0},
}


@pytest.mark.parametrize("space", ["srgb", "aces2065-1"])
@pytest.mark.parametrize("case", list(SENSORS))
def test_pixel_sensor_create(case, space):
    j = JaxSensor.create(jax_space(space), **SENSORS[case])
    t = TorchSensor.create(torch_space(space), **SENSORS[case])
    assert t.imaging_ratio == j.imaging_ratio
    np.testing.assert_array_equal(t.xyz_from_sensor_rgb, j.xyz_from_sensor_rgb)
    np.testing.assert_array_equal(t.rgb_bar_dense, j.rgb_bar_dense)
    rng = np.random.default_rng(2)
    lam = rng.uniform(360, 830, (2000, 4)).astype(np.float32)
    pdf = rng.uniform(0.001, 0.01, (2000, 4)).astype(np.float32)
    l = rng.uniform(0, 5, (2000, 4)).astype(np.float32)
    l[:10] = 0.0
    pdf[:5] = 0.0
    assert_parity(
        lambda l, lam, pdf: j.to_sensor_rgb(l, jsampled.SampledWavelengths(lam=lam, pdf=pdf)),
        lambda l, lam, pdf: t.to_sensor_rgb(l, tsampled.SampledWavelengths(lam=lam, pdf=pdf)),
        l, lam, pdf,
    )


def test_unknown_sensor_raises_value_error():
    with pytest.raises(ValueError, match="unknown sensor"):
        TorchSensor.create(torch_space("srgb"), sensor_name="canon_eos_100d")
    with pytest.raises(ValueError):
        JaxSensor.create(jax_space("srgb"), sensor_name="canon_eos_100d")


def test_sensor_fitted_to_an_rgb_response():
    """The least-squares fit of the 24 swatches for a sensor of its own
    RGB response (three Gaussian-like curves), under a D illuminant."""
    lam = np.arange(360.0, 831.0)
    curves = [np.exp(-0.5 * ((lam - c) / 30.0) ** 2) for c in (600.0, 540.0, 450.0)]
    jbar = tuple(jspec.DenselySampledSpectrum(c) for c in curves)
    tbar = tuple(tspec.DenselySampledSpectrum(c) for c in curves)
    j = JaxSensor(jax_space("srgb"), jspec.d_illuminant(5500.0), 1.0, jbar)
    t = TorchSensor(torch_space("srgb"), tspec.d_illuminant(5500.0), 1.0, tbar)
    np.testing.assert_allclose(t.xyz_from_sensor_rgb, j.xyz_from_sensor_rgb, rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_array_equal(t.rgb_bar_dense, j.rgb_bar_dense)


def test_cie_xyz_sample_and_planck_device():
    lam = np.random.default_rng(3).uniform(350, 840, (3000, 4)).astype(np.float32)
    assert_parity(jspec.cie_xyz_sample, tspec.cie_xyz_sample, lam)
    assert_parity(lambda x: jspec.planck_device(x, 4000.0), lambda x: tspec.planck_device(x, 4000.0),
                  lam, rtol=2e-6)


@pytest.mark.parametrize("fn", ["ss_average", "ss_is_black", "ss_max_component"])
def test_sampled_spectrum_helpers(fn):
    s = np.random.default_rng(4).uniform(0, 1, (500, 4)).astype(np.float32)
    s[:5] = 0.0
    assert_parity(getattr(jsampled, fn), getattr(tsampled, fn), s)


def test_sampled_spectrum_const_div_and_uniform_wavelengths():
    a = np.random.default_rng(5).uniform(0, 1, (500, 4)).astype(np.float32)
    b = a.copy()
    b[:7] = 0.0
    assert_parity(jsampled.ss_safe_div, tsampled.ss_safe_div, a, b)
    np.testing.assert_array_equal(tsampled.ss_const(0.5, (3,)).numpy(),
                                  np.asarray(jsampled.ss_const(0.5, (3,))))
    u = np.random.default_rng(6).random(1000).astype(np.float32)
    assert_parity(lambda u: (lambda w: (w.lam, w.pdf))(
                      jsampled.SampledWavelengths.sample_uniform(u)),
                  lambda u: (lambda w: (w.lam, w.pdf))(
                      tsampled.SampledWavelengths.sample_uniform(u)), u)
