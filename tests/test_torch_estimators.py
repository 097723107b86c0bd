"""The other estimators and the render switches of the port against the
reference, on the CPU.

- ``li_simple_path`` (with NEE and BSDF sampling, and with uniform
  sampling through ``integrator_options``) and ``li_random_walk`` on
  tests/test_wavefront.py's scene (24x24, 2 spp, depth 3): the port's
  megakernel image against the reference's, run op by op
  (``jax.disable_jit``; jitted, XLA contracts FMAs), under
  tests/test_torch_wavefront.py's criteria.  Not every pixel agrees:
  without MIS, a wall point 0.01 below the plane of the quad light sees it
  edge-on, and sampling that nearly degenerate spherical triangle moves
  the sampled light point by ~2% for a last-ulp difference in its
  trigonometry (1 of 576 pixels of simplepath when this was written).
- tests/test_render_e2e.py's white furnace per estimator (a white diffuse
  sphere in a unit D65 environment: every channel's mean within 0.06 of
  1) in the port, at its sizes.
- tests/test_oracle.py's independent numpy path tracer (two gray spheres
  with interreflection) against the port's megakernel at 128 spp (the
  reference's test renders 512 and is marked slow): the image mean within
  0.01, the channels within 2% of each other and 4x4 block means within
  0.035, that test's own gates.
- ``regularize`` and the two jitter options (read by both loaders from
  ``Option`` lines) through the wavefront, against the reference's jitted
  wavefront under tests/test_torch_wavefront.py's criteria (at least 99%
  of pixels within rtol 1e-3 / atol 1e-4, means within 1e-3) with equal
  traced rays and iterations; each switch changes the image.
"""

import os

os.environ.setdefault("OMP_NUM_THREADS", "1")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shimmer_tpu.film.filters import get_camera_sample as jax_camera_sample
from shimmer_tpu.integrators.path import li_random_walk as jax_li_random_walk
from shimmer_tpu.integrators.path import li_simple_path as jax_li_simple_path
from shimmer_tpu.loading.parser import parse_str as jax_parse
from shimmer_tpu.loading.scene_builder import SceneBuilder as JaxBuilder
from shimmer_tpu.render import make_wavefront_renderer as jax_wavefront
from shimmer_tpu.render import pixel_blocks as jax_blocks
from shimmer_tpu.samplers import IndependentSampler as JaxIndependent
from shimmer_tpu_torch.cameras import CameraTransform, PerspectiveCamera
from shimmer_tpu_torch.color.colorspace import get_named_color_space
from shimmer_tpu_torch.convert import scene_from_numpy
from shimmer_tpu_torch.film.film import PixelSensor, RgbFilm
from shimmer_tpu_torch.film.filters import BoxFilter
from shimmer_tpu_torch.lights import lights as lt
from shimmer_tpu_torch.loading.parser import parse_str
from shimmer_tpu_torch.loading.scene_builder import SceneBuilder
from shimmer_tpu_torch.materials import material as mtl
from shimmer_tpu_torch.ops.transform import Transform
from shimmer_tpu_torch.render import make_wave_renderer, make_wavefront_renderer, pixel_blocks
from shimmer_tpu_torch.render import render
from shimmer_tpu_torch.samplers import IndependentSampler
from shimmer_tpu_torch.scene_builder import build_scene
from test_oracle import ALBEDO, CAM_POS, CENTERS, FOV, MAX_DEPTH, RADII, _oracle_render
from test_torch_wavefront import assert_images_agree
from test_wavefront import _scene_cam_film as jax_wavefront_scene
from torch_parity import ensure_reference_sah, jax_scene_to_numpy

torch.set_num_threads(1)

RES = 24
SPP = 2
DEPTH = 3


@pytest.fixture(scope="module")
def wavefront_scene():
    ensure_reference_sah()
    jscene, jcam, jfilm = jax_wavefront_scene(RES)
    ct = jcam.camera_transform
    w2c = ct.world_from_render @ ct.render_from_camera
    cam = PerspectiveCamera(
        CameraTransform(Transform(m=np.asarray(w2c.m), m_inv=np.asarray(w2c.m_inv))),
        (RES, RES), fov=50.0)
    cs = get_named_color_space("srgb")
    film = RgbFilm((RES, RES), BoxFilter(), PixelSensor(cs), cs)
    arrays, census = jax_scene_to_numpy(jscene)
    return (jscene, jcam, jfilm), (scene_from_numpy(arrays, census, device="cpu"), cam, film)


def _jax_estimator_image(jscene, jcam, jfilm, li_fn, opts):
    """The reference's megakernel wave (its render_pixel_samples body)
    over one full-image block, op by op."""
    sampler = JaxIndependent(SPP)
    pixel_xy = jax_blocks(jfilm, RES * RES)[0][0]
    fs = jfilm.init_state()
    with jax.disable_jit():
        for i in range(SPP):
            s_state = sampler.start_pixel_sample(pixel_xy, jnp.uint32(i))
            u_lam, s_state = sampler.get_1d(s_state)
            swl = jfilm.sample_wavelengths(u_lam)
            u_filter, s_state = sampler.get_pixel_2d(s_state)
            u_lens, s_state = sampler.get_2d(s_state)
            p_film, weight, u_lens = jax_camera_sample(jfilm.filter, pixel_xy, u_filter, u_lens)
            l = li_fn(jscene, jcam.generate_ray(p_film, u_lens), swl, sampler, s_state, DEPTH,
                      **opts)
            l = jnp.where(jnp.any(~jnp.isfinite(l), axis=-1)[..., None], 0.0, l)
            fs = jfilm.add_samples(fs, pixel_xy, l, swl, weight, unique=True)
    return np.asarray(jfilm.get_image(fs))


ESTIMATORS = {
    "simplepath": (jax_li_simple_path, "simplepath", {}),
    "simplepath_uniform": (jax_li_simple_path, "simplepath", {"sample_bsdf": False}),
    "randomwalk": (jax_li_random_walk, "randomwalk", {}),
}


@pytest.mark.parametrize("case", list(ESTIMATORS))
def test_estimator_matches_reference(wavefront_scene, case):
    (jscene, jcam, jfilm), (scene, cam, film) = wavefront_scene
    jax_fn, name, opts = ESTIMATORS[case]
    ref = _jax_estimator_image(jscene, jcam, jfilm, jax_fn, opts)
    blocks, valids = pixel_blocks(film, RES * RES, device="cpu")
    wave = make_wave_renderer(scene, cam, film, IndependentSampler(SPP), name, max_depth=DEPTH,
                              integrator_options=opts)
    fs, stats = wave(film.init_state("cpu"), torch.arange(SPP), blocks[0], valids[0])
    img = film.get_image(fs).numpy()
    assert stats["rays"] is None
    assert np.isfinite(img).all() and img.mean() > 0
    assert_images_agree(img, ref)


def _furnace(res=32):
    cs = get_named_color_space("srgb")
    ct = CameraTransform(Transform.look_at([0.0, 0.0, -4.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]))
    cam = PerspectiveCamera(ct, (res, res), fov=45.0)
    film = RgbFilm((res, res), BoxFilter(), PixelSensor(cs), cs)
    return cam, film, cs


@pytest.mark.parametrize("integrator", ["path", "simplepath", "randomwalk"])
def test_white_furnace(integrator):
    """tests/test_render_e2e.py::TestFurnace::test_white_furnace in the
    port."""
    cam, film, cs = _furnace()
    scene = build_scene(
        None, materials=[{"kind": mtl.DIFFUSE, "reflectance": [1.0, 1.0, 1.0]}],
        lights=[{"kind": lt.UNIFORM_INFINITE, "spectrum": cs.illuminant, "photometric": True}],
        spheres=[{"radius": 1.0, "material_id": 0,
                  "object_to_render": cam.camera_transform.render_from_world()}],
        render_from_world=cam.camera_transform.render_from_world(), device="cpu",
    )
    depth = 16 if integrator == "path" else 8
    image, _ = render(scene, cam, film, IndependentSampler(64), integrator=integrator, spp=64,
                      max_depth=depth, wave_spp=32)
    img = image.numpy()
    assert np.isfinite(img).all()
    np.testing.assert_allclose(img.mean(axis=(0, 1)), 1.0, atol=0.06)


def test_megakernel_matches_numpy_oracle():
    """tests/test_oracle.py's gates, the port's megakernel at 128 spp
    against the oracle at 1024."""
    cs = get_named_color_space("srgb")
    ct = CameraTransform(Transform.look_at(CAM_POS, [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]))
    cam = PerspectiveCamera(ct, (24, 24), fov=FOV)
    film = RgbFilm((24, 24), BoxFilter(), PixelSensor(cs), cs)
    r2w = cam.camera_transform.render_from_world()
    scene = build_scene(
        None, materials=[{"kind": mtl.DIFFUSE, "reflectance": [ALBEDO] * 3}],
        lights=[{"kind": lt.UNIFORM_INFINITE, "spectrum": cs.illuminant, "photometric": True}],
        spheres=[{"radius": float(RADII[i]), "material_id": 0,
                  "object_to_render": r2w @ Transform.translate(CENTERS[i])}
                 for i in range(len(RADII))],
        render_from_world=r2w, device="cpu",
    )
    spp = 128
    image, _ = render(scene, cam, film, IndependentSampler(spp, seed=3), spp=spp,
                      max_depth=MAX_DEPTH, wave_spp=64, wavefront=False)
    img = image.numpy()
    assert np.isfinite(img).all()
    oracle = _oracle_render(spp=1024)
    assert abs(img.mean() - oracle.mean()) < 0.01, (img.mean(), oracle.mean())
    ch = img.mean(axis=(0, 1))
    np.testing.assert_allclose(ch, ch.mean(), rtol=0.02)
    blk = img.mean(-1).reshape(6, 4, 6, 4).mean((1, 3))
    blk_o = oracle.reshape(6, 4, 6, 4).mean((1, 3))
    np.testing.assert_allclose(blk, blk_o, atol=0.035)


SWITCH_SCENE = """
%s
LookAt 0 1.2 -3.5  0 0.4 0  0 1 0
Camera "perspective" "float fov" [45]
Film "rgb" "integer xresolution" [20] "integer yresolution" [16]
Sampler "independent" "integer pixelsamples" [4]
Integrator "path" "integer maxdepth" [4]
WorldBegin
LightSource "infinite" "rgb L" [0.2 0.2 0.25]
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [10 10 10]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
      "point3 P" [-0.6 2.5 -0.6  0.6 2.5 -0.6  0.6 2.5 0.6  -0.6 2.5 0.6]
AttributeEnd
Material "diffuse" "rgb reflectance" [0.6 0.55 0.5]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point3 P" [-4 0 -4  4 0 -4  4 0 4  -4 0 4]
Material "conductor" "spectrum eta" "metal-Au-eta" "spectrum k" "metal-Au-k"
    "float roughness" [0.01]
Translate 0 0.6 0
Shape "sphere" "float radius" [0.6]
"""
SWITCHES = {
    "regularize": ("", True),
    "jitter_options_and_regularize": ('Option "bool disablepixeljitter" true\n'
                                      'Option "bool disablewavelengthjitter" true', True),
}


@pytest.fixture(scope="module")
def plain_switch_render():
    b = SceneBuilder()
    parse_str(SWITCH_SCENE % "", b)
    job = b.create(device="cpu")
    return render(job.scene, job.camera, job.film, job.sampler, spp=job.spp, max_depth=4,
                  collect_stats=True)[0].numpy()


@pytest.mark.parametrize("case", list(SWITCHES))
def test_switches_match_reference(case, plain_switch_render):
    ensure_reference_sah()
    options, regularize = SWITCHES[case]
    text = SWITCH_SCENE % options
    jb, b = JaxBuilder(), SceneBuilder()
    jax_parse(text, jb)
    parse_str(text, b)
    jjob, job = jb.create(), b.create(device="cpu")
    assert (job.disable_pixel_jitter, job.disable_wavelength_jitter) == (
        jjob.disable_pixel_jitter, jjob.disable_wavelength_jitter) == (bool(options),) * 2
    kw = dict(max_depth=4, regularize=regularize,
              disable_pixel_jitter=job.disable_pixel_jitter,
              disable_wavelength_jitter=job.disable_wavelength_jitter)
    n = 20 * 16
    jblocks, jvalids = jax_blocks(jjob.film, n)
    jwave = jax_wavefront(jjob.scene, jjob.camera, jjob.film, jjob.sampler, with_stats=True, **kw)
    jstate, jstats = jwave(jjob.film.init_state(), jnp.arange(4, dtype=jnp.uint32), jblocks[0],
                           jvalids[0])
    ref = np.asarray(jjob.film.get_image(jstate))
    blocks, valids = pixel_blocks(job.film, n, device="cpu")
    wave = make_wavefront_renderer(job.scene, job.camera, job.film, job.sampler, **kw)
    state, stats = wave(job.film.init_state("cpu"), torch.arange(4), blocks[0], valids[0])
    img = job.film.get_image(state).numpy()
    assert float(stats["rays"]) == float(jstats["rays"])
    assert float(stats["iters"]) == float(jstats["iters"])
    assert_images_agree(img, ref)
    # Each switch moves the image away from the render without it.
    assert not np.allclose(img, plain_switch_render, rtol=1e-3, atol=1e-4)
