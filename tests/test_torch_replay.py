"""The replay wavefront (render.py::make_replay_wavefront_renderer) in the
port: tests/test_grad.py::TestReplayWavefrontGradients' two cases on the
port (12x12, depth 3; 2 spp for the value and the megakernel gradient,
4 spp for the finite difference), the film state's gradient passing
through the wave unchanged, and the port's value and gradient against the
reference's replay run op by op (``jax.disable_jit``; jitted, XLA
contracts FMAs) within ``AD_RTOL``."""

import os

os.environ.setdefault("OMP_NUM_THREADS", "1")

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shimmer_tpu.render import full_image_pixels as jax_full_image_pixels
from shimmer_tpu.render import make_replay_wavefront_renderer as jax_replay_renderer
from shimmer_tpu.samplers import IndependentSampler as JaxIndependent
from shimmer_tpu_torch.film.film import FilmState
from shimmer_tpu_torch.integrators.path import li_path
from shimmer_tpu_torch.render import (full_image_pixels, make_replay_wavefront_renderer,
                                      make_wavefront_renderer, render_pixel_samples)
from shimmer_tpu_torch.samplers import IndependentSampler
from torch_grad import (AD_RTOL, _sphere_and_light, jax_camera, jax_film, port_camera,
                        port_fd_vs_ad, port_film, port_scene, replace, set_entry)

torch.set_num_threads(1)

RES, DEPTH = 12, 3
ENTRY = (0, 1)  # reflectance coefficient of tests/test_grad.py's replay cases


@pytest.fixture(scope="module")
def scenes():
    jcam = jax_camera(RES)
    jscene = _sphere_and_light([0.6, 0.5, 0.4], 20.0, 1.0,
                               jcam.camera_transform.render_from_world())
    return jscene, port_scene(jscene), port_camera(jcam), port_film(RES)


def _inputs(film, spp):
    pixel_xy = full_image_pixels(film, "cpu")
    return (pixel_xy, torch.ones(pixel_xy.shape[0], dtype=torch.bool),
            torch.arange(spp), IndependentSampler(spp))


def _with_theta(scene, theta):
    return replace(scene, "materials",
                   reflectance=set_entry(scene.materials.reflectance, ENTRY, theta))


def _value_grad(f, theta0):
    th = torch.tensor(theta0, requires_grad=True)
    v = f(th)
    (g,) = torch.autograd.grad(v, th)
    return float(v.detach()), float(g)


def test_replay_value_is_the_wavefront_and_gradient_the_megakernel(scenes):
    _, scene, cam, film = scenes
    pixel_xy, valid, idx, sampler = _inputs(film, 2)
    n = pixel_xy.shape[0]
    replay = make_replay_wavefront_renderer(scene, cam, film, sampler, max_depth=DEPTH)
    theta0 = float(scene.materials.reflectance[ENTRY])

    def f_replay(th):
        return replay(_with_theta(scene, th), film.init_state("cpu"), idx, pixel_xy,
                      valid).rgb_sum.sum() / n

    def f_mega(th):
        fs, _ = render_pixel_samples(_with_theta(scene, th), cam, film, sampler, li_path, {},
                                     film.init_state("cpu"), idx, pixel_xy, pixel_valid=valid,
                                     max_depth=DEPTH)
        return fs.rgb_sum.sum() / n

    v_r, g_r = _value_grad(f_replay, theta0)
    v_m, g_m = _value_grad(f_mega, theta0)
    fs, _ = make_wavefront_renderer(scene, cam, film, sampler, max_depth=DEPTH)(
        film.init_state("cpu"), idx, pixel_xy, valid)
    v_wf = float(fs.rgb_sum.sum() / n)
    # The forward value comes from the wavefront.
    assert abs(v_r - v_wf) <= 1e-5 * max(abs(v_wf), 1.0)
    np.testing.assert_allclose(v_r, v_m, rtol=1e-4)
    # The replayed gradient is the megakernel's.
    assert abs(g_r) > 1e-7
    np.testing.assert_allclose(g_r, g_m, rtol=1e-5)


def test_replay_gradient_matches_fd(scenes):
    _, scene, cam, film = scenes
    pixel_xy, valid, idx, sampler = _inputs(film, 4)
    replay = make_replay_wavefront_renderer(scene, cam, film, sampler, max_depth=DEPTH)

    def f(th):
        return replay(_with_theta(scene, th), film.init_state("cpu"), idx, pixel_xy,
                      valid).rgb_sum.sum() / pixel_xy.shape[0]

    g_ad, _ = port_fd_vs_ad(f, float(scene.materials.reflectance[ENTRY]), h=1e-2, rtol=5e-2)
    assert abs(g_ad) > 1e-7


def test_film_state_gradient_passes_through(scenes):
    _, scene, cam, film = scenes
    pixel_xy, valid, idx, sampler = _inputs(film, 2)
    replay = make_replay_wavefront_renderer(scene, cam, film, sampler, max_depth=DEPTH)
    start = film.init_state("cpu")
    leaves = [t.clone().requires_grad_(True)
              for t in (start.rgb_sum + 1.0, start.weight_sum + 2.0, start.rgb_splat + 3.0)]
    th = torch.tensor(float(scene.materials.reflectance[ENTRY]), requires_grad=True)
    out = replay(_with_theta(scene, th), FilmState(*leaves), idx, pixel_xy, valid)
    outs = (out.rgb_sum, out.weight_sum, out.rgb_splat)
    gen = torch.Generator().manual_seed(17)
    gs = [torch.randn(o.shape, generator=gen) for o in outs]
    grads = torch.autograd.grad(outs, leaves + [th], gs)
    for g, want in zip(grads[:3], gs):
        assert torch.equal(g, want)
    assert float(grads[3]) != 0.0


def test_replay_matches_reference_op_by_op(scenes):
    jscene, scene, cam, film = scenes
    spp = 2
    pixel_xy, valid, idx, sampler = _inputs(film, spp)
    n = pixel_xy.shape[0]
    replay = make_replay_wavefront_renderer(scene, cam, film, sampler, max_depth=DEPTH)
    theta0 = float(scene.materials.reflectance[ENTRY])
    v, g = _value_grad(lambda th: replay(_with_theta(scene, th), film.init_state("cpu"), idx,
                                         pixel_xy, valid).rgb_sum.sum() / n, theta0)

    jcam, jfilm = jax_camera(RES), jax_film(RES)
    jreplay = jax_replay_renderer(jscene, jcam, jfilm, JaxIndependent(spp), max_depth=DEPTH)
    jpx = jax_full_image_pixels(jfilm)
    jvalid = jnp.ones(jpx.shape[0], bool)
    jidx = jnp.arange(spp, dtype=jnp.uint32)

    def jf(theta):
        mats = dataclasses.replace(
            jscene.materials, reflectance=jscene.materials.reflectance.at[ENTRY].set(theta))
        fs = jreplay(dataclasses.replace(jscene, materials=mats), jfilm.init_state(), jidx, jpx,
                     jvalid)
        return jnp.sum(fs.rgb_sum) / jpx.shape[0]

    with jax.disable_jit():
        jv, jg = jax.value_and_grad(jf)(jnp.float32(theta0))
    np.testing.assert_allclose(v, float(jv), rtol=AD_RTOL)
    assert abs(g) > 1e-7
    np.testing.assert_allclose(g, float(jg), rtol=AD_RTOL, err_msg=f"port={g} reference={jg}")
