"""The cameras of the port against the reference, on the CPU: the
perspective camera (pinhole and thin lens, default and custom screen
windows), the orthographic camera (with and without a lens) and the
spherical camera (equal-area and equirectangular), each under the three
render spaces, through ``generate_ray`` and ``generate_ray_differential``,
and the shutter's time sample.

The transforms are composed on the host in numpy by both packages, so the
render-from-camera matrices are byte-equal.  Applying them, the reference
contracts through an einsum and the port adds in the order
``ops/transform.py`` spells out, and sin / cos / the concentric disk's
trig round an ulp apart: rays are held within atol 1e-6 (positions of
order 1 here, unit directions)."""

import os

os.environ.setdefault("OMP_NUM_THREADS", "1")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shimmer_tpu import cameras as jc
from shimmer_tpu.ops.ray import RayDifferential as JaxRayDifferential
from shimmer_tpu.ops.ray import Ray as JaxRay
from shimmer_tpu.ops.transform import Transform as JT
from shimmer_tpu_torch import cameras as tc
from shimmer_tpu_torch.ops.ray import Ray, RayDifferential
from shimmer_tpu_torch.ops.transform import Transform as TT

torch.set_num_threads(1)

RES = (40, 30)
SPACES = ["camera", "cameraworld", "world"]
CAMERAS = {
    "pinhole": ("PerspectiveCamera", {"fov": 50.0}),
    "thin_lens_screenwindow": ("PerspectiveCamera", {
        "fov": 35.0, "lens_radius": 0.1, "focal_distance": 3.0,
        "screen_window": ((-0.5, -0.4), (0.7, 0.3))}),
    "orthographic": ("OrthographicCamera", {}),
    "orthographic_lens": ("OrthographicCamera", {
        "lens_radius": 0.1, "focal_distance": 2.0, "screen_window": ((-2.0, -1.5), (2.0, 1.5))}),
    "spherical_equalarea": ("SphericalCamera", {"mapping": "equalarea"}),
    "spherical_equirect": ("SphericalCamera", {"mapping": "equirect"}),
}


def _world_from_camera():
    m = JT.look_at(np.array([0.3, 1.0, -3.5]), np.array([0.0, 0.5, 0.0]),
                   np.array([0.0, 1.0, 0.0]))
    return m, TT(m=np.asarray(m.m), m_inv=np.asarray(m.m_inv))


def _both(kind, space, shutter=(0.0, 1.0)):
    jm, tm = _world_from_camera()
    cls, kw = CAMERAS[kind]
    common = {"shutter_open": shutter[0], "shutter_close": shutter[1]}
    j = getattr(jc, cls)(jc.CameraTransform(jm, space), RES, **kw, **common)
    t = getattr(tc, cls)(tc.CameraTransform(tm, space), RES, **kw, **common)
    return j, t


def _inputs(n=1000):
    rng = np.random.default_rng(0)
    p_film = (rng.random((n, 2)) * RES).astype(np.float32)
    p_film[:3] = [[0, 0], [RES[0], RES[1]], [RES[0] / 2, RES[1] / 2]]
    u_lens = rng.random((n, 2)).astype(np.float32)
    u_lens[:2] = [[0.5, 0.5], [0.0, 1.0]]
    return p_film, u_lens


@pytest.mark.parametrize("space", SPACES)
def test_camera_transform(space):
    jm, tm = _world_from_camera()
    j, t = jc.CameraTransform(jm, space), tc.CameraTransform(tm, space)
    for attr in ("world_from_render", "render_from_camera"):
        np.testing.assert_array_equal(getattr(t, attr).m, np.asarray(getattr(j, attr).m))
        np.testing.assert_array_equal(getattr(t, attr).m_inv,
                                      np.asarray(getattr(j, attr).m_inv))
    np.testing.assert_array_equal(t.render_from_world().m, np.asarray(j.render_from_world().m))


def test_unknown_render_space_raises():
    _, tm = _world_from_camera()
    with pytest.raises(ValueError, match="rendering coordinate system"):
        tc.CameraTransform(tm, "screen")


@pytest.mark.parametrize("space", SPACES)
@pytest.mark.parametrize("kind", list(CAMERAS))
def test_generate_ray(kind, space):
    j, t = _both(kind, space)
    p_film, u_lens = _inputs()
    jr = j.generate_ray(jnp.asarray(p_film), jnp.asarray(u_lens))
    tr = t.generate_ray(torch.from_numpy(p_film), torch.from_numpy(u_lens))
    assert isinstance(jr, JaxRay) and isinstance(tr, Ray)
    np.testing.assert_allclose(tr.o.numpy(), np.asarray(jr.o), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tr.d.numpy(), np.asarray(jr.d), rtol=0, atol=1e-6)
    if kind.startswith("pinhole") or kind.startswith("spherical"):
        assert np.abs(np.linalg.norm(tr.d.numpy(), axis=-1) - 1).max() < 1e-6


@pytest.mark.parametrize("space", ["cameraworld", "world"])
@pytest.mark.parametrize("kind", list(CAMERAS))
def test_generate_ray_differential(kind, space):
    j, t = _both(kind, space)
    p_film, u_lens = _inputs(300)
    jr = j.generate_ray_differential(jnp.asarray(p_film), jnp.asarray(u_lens))
    tr = t.generate_ray_differential(torch.from_numpy(p_film), torch.from_numpy(u_lens))
    assert isinstance(jr, JaxRayDifferential) and isinstance(tr, RayDifferential)
    for field in ("rx_o", "rx_d", "ry_o", "ry_d"):
        np.testing.assert_allclose(getattr(tr, field).numpy(), np.asarray(getattr(jr, field)),
                                   rtol=0, atol=1e-6, err_msg=field)
    np.testing.assert_allclose(tr.ray.d.numpy(), np.asarray(jr.ray.d), rtol=0, atol=1e-6)
    assert tr.has_differentials.all()


def test_ray_differential_scale_and_from_ray():
    rng = np.random.default_rng(1)
    o, d, rxo, rxd, ryo, ryd = (rng.random((50, 3)).astype(np.float32) for _ in range(6))
    jrd = JaxRayDifferential(JaxRay(jnp.asarray(o), jnp.asarray(d)), jnp.asarray(rxo),
                             jnp.asarray(rxd), jnp.asarray(ryo), jnp.asarray(ryd),
                             jnp.ones(50, bool)).scale_differentials(0.25)
    trd = RayDifferential(Ray(torch.from_numpy(o), torch.from_numpy(d)), torch.from_numpy(rxo),
                          torch.from_numpy(rxd), torch.from_numpy(ryo), torch.from_numpy(ryd),
                          torch.ones(50, dtype=torch.bool)).scale_differentials(0.25)
    for field in ("rx_o", "rx_d", "ry_o", "ry_d"):
        np.testing.assert_array_equal(getattr(trd, field).numpy(), np.asarray(getattr(jrd, field)))
    empty = RayDifferential.from_ray(Ray(torch.from_numpy(o), torch.from_numpy(d)))
    assert not empty.has_differentials.any() and (empty.rx_d == 0).all()


def test_shutter_time_and_pixel_spread():
    j, t = _both("thin_lens_screenwindow", "cameraworld", shutter=(0.2, 0.7))
    u = np.random.default_rng(2).random(100).astype(np.float32)
    np.testing.assert_array_equal(t.sample_time(torch.from_numpy(u)).numpy(),
                                  np.asarray(j.sample_time(jnp.asarray(u))))
    assert t.pixel_spread == j.pixel_spread
    np.testing.assert_allclose(t.dx_camera, np.asarray(j.dx_camera), rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(t.camera_from_raster.m, np.asarray(j.camera_from_raster.m))
