"""The pixel filters of the port against the reference, on the CPU.

- ``evaluate``, ``integral`` and ``sample`` of the box, triangle,
  Gaussian, Mitchell and Lanczos-sinc filters, and ``Filter.create``'s
  parameter defaults.
- The sampled filters' 64 x 64 tables: built by the port from the
  reference's filter values, every table (func, conditional and marginal
  CDFs and integrals) byte-equal to the reference's (the CDFs go through
  ``xla_cumsum``, the reference's CPU cumsum order).  The port's own
  values: Mitchell's (polynomials only) and so its tables are byte-equal;
  the Gaussian's exp and the sinc's sin round an ulp apart between torch
  and XLA, so their values are held within rtol 1e-6 / atol 1e-8 (the
  Gaussian subtracts its value at the radius, so a last-ulp exp
  difference is large relative to a value near the edge) and their tables
  within rtol 2e-6 / atol 1e-8.
- Sampling: box, triangle and Mitchell bit-equal.  Gaussian and sinc:
  their tables differ in the last ulps, and a cell whose |f| is tiny (at
  the filter's edge, or the sinc's zero crossings) has a CDF step of a
  few ulps, so the position inside it, (u - c0) / (c1 - c0), and the
  weight f / pdf there move by more: points are held within 2e-5 of the
  radius, 99.9% of weights within rtol 1e-4 and all within 1e-2, and the
  mean weight within 1e-5 relative.  A draw within an ulp of a cell's CDF
  edge can pick the neighbouring cell in one package; those lanes (at
  most a few in 10^4) are counted, not compared.
- ``erf_inv`` (rtol 2e-6: torch and XLA use different approximations),
  ``sinc`` / ``windowed_sinc`` (4 ulps: the window multiplies two sines'
  roundings) and ``sample_tent`` (bit-equal).
"""

import os

os.environ.setdefault("OMP_NUM_THREADS", "1")

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shimmer_tpu.film import filters as jf
from shimmer_tpu.ops import math as jmath
from shimmer_tpu.ops import sampling as jsampling
from shimmer_tpu_torch.film import filters as tf
from shimmer_tpu_torch.ops import math as tmath
from shimmer_tpu_torch.ops import sampling as tsampling
from shimmer_tpu_torch.ops.sampling import build_piecewise_constant_2d
from torch_parity import assert_parity, ulp_gap

torch.set_num_threads(1)

NAMES = ["box", "triangle", "gaussian", "mitchell", "sinc"]
PARAMS = {
    "box": {"xradius": 0.7, "yradius": 0.4},
    "triangle": {"xradius": 1.5, "yradius": 2.5},
    "gaussian": {"xradius": 2.0, "yradius": 1.25, "sigma": 0.6},
    "mitchell": {"xradius": 2.5, "B": 0.4, "C": 0.3},
    "sinc": {"xradius": 3.0, "yradius": 4.5, "tau": 2.5},
}
TABLE_FIELDS = ("func", "cond_cdf", "cond_int", "marg_cdf", "marg_func", "marg_int")


def _both(name, params):
    return jf.Filter.create(name, **params), tf.Filter.create(name, **params)


@pytest.mark.parametrize("custom", [False, True], ids=["defaults", "params"])
@pytest.mark.parametrize("name", NAMES)
def test_evaluate_and_integral(name, custom):
    j, t = _both(name, PARAMS[name] if custom else {})
    assert t.radius == j.radius
    assert t.integral() == pytest.approx(j.integral(), rel=1e-6)
    rx, ry = j.radius
    p = np.random.default_rng(0).uniform(-1.2, 1.2, (4096, 2)) * [rx, ry]
    p[:4] = [[0, 0], [rx, ry], [-rx, 0.5 * ry], [1.5 * rx, 0]]
    a = np.asarray(j.evaluate(jnp.asarray(p, jnp.float32)))
    b = t.evaluate(torch.as_tensor(p, dtype=torch.float32)).numpy()
    if name in ("gaussian", "sinc"):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-8)
    else:
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("name", ["gaussian", "mitchell", "sinc"])
def test_sampled_table_is_byte_equal_from_the_same_values(name):
    j, t = _both(name, PARAMS[name])
    rx, ry = j.radius
    ours = build_piecewise_constant_2d(np.abs(np.asarray(j._f_table)),
                                       domain=((-rx, -ry), (rx, ry)), device="cpu")
    for field in TABLE_FIELDS:
        np.testing.assert_array_equal(getattr(ours, field).numpy(),
                                      np.asarray(getattr(j._dist, field)), err_msg=field)
    assert ours.domain == tuple(map(tuple, j._dist.domain))
    # The port's own table, from its own values.
    exact = name == "mitchell"
    if exact:
        np.testing.assert_array_equal(t._f_table.numpy(), np.asarray(j._f_table))
    else:
        np.testing.assert_allclose(t._f_table.numpy(), np.asarray(j._f_table), rtol=1e-6,
                                   atol=1e-8)
    for field in TABLE_FIELDS:
        a, b = np.asarray(getattr(j._dist, field)), getattr(t._dist, field).numpy()
        if exact:
            np.testing.assert_array_equal(b, a, err_msg=field)
        else:
            np.testing.assert_allclose(b, a, rtol=2e-6, atol=1e-8, err_msg=field)


@pytest.mark.parametrize("name", NAMES)
def test_sample(name):
    j, t = _both(name, PARAMS[name])
    u = np.random.default_rng(1).random((10000, 2)).astype(np.float32)
    u[:3] = [[0, 0], [0.5, 0.5], [0.99999994, 0.99999994]]
    pj, wj = (np.asarray(x) for x in j.sample(jnp.asarray(u)))
    pt, wt = (x.numpy() for x in t.sample(torch.from_numpy(u)))
    if name in ("box", "triangle", "mitchell"):
        np.testing.assert_array_equal(pt, pj)
        np.testing.assert_array_equal(wt, wj)
        return
    # The cell each package picked, from its own point.
    n = tf._SampledFilter._TABLE
    rx, ry = j.radius

    def cell(p):
        return np.floor((p + [rx, ry]) / [2 * rx, 2 * ry] * n).astype(np.int64)

    same = (cell(pj) == cell(pt)).all(-1)
    print(f"{name}: {int((~same).sum())} of {len(u)} draws in a neighbouring cell")
    assert (~same).sum() <= 5
    np.testing.assert_allclose(pt[same], pj[same], rtol=0, atol=2e-5 * max(rx, ry))
    rel = np.abs(wt[same] - wj[same]) / np.maximum(np.abs(wj[same]), 1e-3)
    assert np.mean(rel <= 1e-4) >= 0.999 and rel.max() <= 1e-2
    assert abs(wt.mean() - wj.mean()) <= 1e-5 * abs(wj.mean())


def test_sampled_filter_follows_its_input_device():
    """The tables are built on the host; sample() uses a copy on the
    device of u (the CPU here), made once."""
    t = tf.Filter.create("gaussian")
    u = torch.rand(8, 2)
    t.sample(u)
    assert list(t._dists) == ["cpu"] and t._dists["cpu"] is t._dist
    assert all(getattr(t._dist, f.name).device.type == "cpu"
               for f in dataclasses.fields(t._dist) if isinstance(getattr(t._dist, f.name),
                                                                  torch.Tensor))


def test_create_rejects_unknown():
    with pytest.raises(ValueError, match="unknown filter"):
        tf.Filter.create("blackman")


def test_get_camera_sample():
    j, t = _both("triangle", {})
    px = np.random.default_rng(2).integers(0, 64, (500, 2)).astype(np.int32)
    uf = np.random.default_rng(3).random((500, 2)).astype(np.float32)
    ul = np.random.default_rng(4).random((500, 2)).astype(np.float32)
    assert_parity(lambda a, b, c: jf.get_camera_sample(j, a, b, c),
                  lambda a, b, c: tf.get_camera_sample(t, a, b, c), px, uf, ul)


def test_erf_inv():
    x = np.random.default_rng(5).uniform(-0.999, 0.999, 20000).astype(np.float32)
    x[:3] = [0.0, 0.5, -0.9]
    assert_parity(jmath.erf_inv, tmath.erf_inv, x, rtol=2e-6, atol=1e-7)


@pytest.mark.parametrize("fn", ["sinc", "windowed_sinc"])
def test_sinc(fn):
    x = np.random.default_rng(6).uniform(-5, 5, 20000).astype(np.float32)
    x[:4] = [0.0, 1e-6, 3.0, -4.0]
    args = () if fn == "sinc" else (4.0, 3.0)
    a = np.asarray(getattr(jmath, fn)(jnp.asarray(x), *args))
    b = getattr(tmath, fn)(torch.from_numpy(x), *args).numpy()
    assert ulp_gap(a, b) <= 4
    assert b[0] == 1.0 and b[1] == 1.0


def test_sample_tent():
    u = np.random.default_rng(7).random(20000).astype(np.float32)
    u[:3] = [0.0, 0.5, 0.99999994]
    assert_parity(lambda u: jsampling.sample_tent(u, 1.7),
                  lambda u: tsampling.sample_tent(u, 1.7), u)
