"""The masked megakernel (``render(..., wavefront=False)``, ``li_path``)
against the reference's, on the CPU.

- tests/test_wavefront.py's scene (a floor, a wall, a diffuse sphere and a
  quad light; 48x48 pixels, the independent sampler, 4 spp, depth 4): the
  port's megakernel image against the reference's megakernel image with
  every pixel within rtol 1e-3 / atol 1e-4, and the traced rays equal.
  The reference runs the body of its ``render_pixel_samples`` with
  ``li_path(return_stats=True)`` op by op (``jax.disable_jit``, ~30 s):
  jitted, XLA contracts FMAs, which moves 3 of the 2304 pixels by up to
  0.6% against the reference's own op-by-op image (the same 3 pixels by
  which the port's wavefront differs from the jitted reference wavefront;
  the port's estimate equals the op-by-op reference's lane for lane).
- The same scene: the port's megakernel against the port's wavefront under
  test_wavefront.py's own gate (max |diff| / max < 2e-3), and the rays
  equal.
- tests/test_media.py's two wavefront-against-megakernel cases (exterior
  fog lit by an emissive sphere; the interface ink slab, read by the
  port's loader), run in the port under their gate.

The scenes are built by the reference and carried across with
``scene_from_numpy``; the cameras are built by each package from the same
matrix.
"""

import os

os.environ.setdefault("OMP_NUM_THREADS", "1")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shimmer_tpu.cameras import CameraTransform as JaxCameraTransform
from shimmer_tpu.cameras import PerspectiveCamera as JaxPerspective
from shimmer_tpu.film.filters import get_camera_sample as jax_camera_sample
from shimmer_tpu.integrators.path import li_path as jax_li_path
from shimmer_tpu.lights import lights as jlt
from shimmer_tpu.materials import material as jmtl
from shimmer_tpu.ops.transform import Transform as JaxTransform
from shimmer_tpu.render import pixel_blocks as jax_blocks
from shimmer_tpu.samplers import IndependentSampler as JaxIndependent
from shimmer_tpu.scene_builder import build_scene as jax_build_scene
from shimmer_tpu.spectra.spectrum import ConstantSpectrum as JaxConstant
from shimmer_tpu_torch.cameras import CameraTransform, PerspectiveCamera
from shimmer_tpu_torch.color.colorspace import get_named_color_space
from shimmer_tpu_torch.convert import scene_from_numpy
from shimmer_tpu_torch.film.film import PixelSensor, RgbFilm
from shimmer_tpu_torch.film.filters import BoxFilter
from shimmer_tpu_torch.loading.parser import parse_str
from shimmer_tpu_torch.loading.scene_builder import SceneBuilder
from shimmer_tpu_torch.ops.transform import Transform
from shimmer_tpu_torch.render import make_wave_renderer, make_wavefront_renderer, pixel_blocks
from shimmer_tpu_torch.render import render as torch_render
from shimmer_tpu_torch.samplers import IndependentSampler
from test_wavefront import _scene_cam_film as jax_wavefront_scene
from torch_parity import ensure_reference_sah, jax_scene_to_numpy

torch.set_num_threads(1)

RES = 48
SPP = 4
DEPTH = 4


def _port_camera(jax_cam, fov):
    """The port's camera over the reference camera's world-from-camera
    matrix (the render-from-camera of the default render space composed
    back)."""
    ct = jax_cam.camera_transform
    w2c = ct.world_from_render @ ct.render_from_camera
    m = Transform(m=np.asarray(w2c.m), m_inv=np.asarray(w2c.m_inv))
    return PerspectiveCamera(CameraTransform(m), jax_cam.resolution, fov=fov)


def _port_film(res):
    cs = get_named_color_space("srgb")
    return RgbFilm(res, BoxFilter(), PixelSensor(cs), cs)


def _port_scene(jscene):
    arrays, census = jax_scene_to_numpy(jscene)
    return scene_from_numpy(arrays, census, device="cpu")


@pytest.fixture(scope="module")
def wavefront_scene():
    ensure_reference_sah()
    jscene, jcam, jfilm = jax_wavefront_scene(RES)
    cam = _port_camera(jcam, 50.0)
    assert np.array_equal(cam.camera_transform.render_from_camera.m,
                          np.asarray(jcam.camera_transform.render_from_camera.m))
    return (jscene, jcam, jfilm), (_port_scene(jscene), cam, _port_film((RES, RES)))


def _jax_megakernel(jscene, jcam, jfilm, sampler, max_depth):
    """The reference's megakernel wave over one full-image block, with
    its traced rays: the body of its render_pixel_samples (one li_path
    call per sample index under a scan) with li_path's stats kept, run op
    by op."""
    blocks, _ = jax_blocks(jfilm, RES * RES)
    pixel_xy = blocks[0]

    @jax.jit
    def wave(scene_arg, sample_indices):
        def one_sample(carry, sample_index):
            fs, rays = carry
            s_state = sampler.start_pixel_sample(pixel_xy, sample_index)
            u_lam, s_state = sampler.get_1d(s_state)
            swl = jfilm.sample_wavelengths(u_lam)
            u_filter, s_state = sampler.get_pixel_2d(s_state)
            u_lens, s_state = sampler.get_2d(s_state)
            p_film, weight, u_lens = jax_camera_sample(jfilm.filter, pixel_xy, u_filter, u_lens)
            ray = jcam.generate_ray(p_film, u_lens)
            l, st = jax_li_path(scene_arg, ray, swl, sampler, s_state, max_depth,
                                return_stats=True)
            l = jnp.where(jnp.any(~jnp.isfinite(l), axis=-1)[..., None], 0.0, l)
            fs = jfilm.add_samples(fs, pixel_xy, l, swl, weight, unique=True)
            return (fs, rays + st["rays"]), None

        (fs, rays), _ = jax.lax.scan(one_sample, (jfilm.init_state(), jnp.float32(0.0)),
                                     sample_indices)
        return fs, rays

    with jax.disable_jit():
        fs, n_rays = wave(jscene, jnp.arange(SPP, dtype=jnp.uint32))
    return np.asarray(jfilm.get_image(fs)), float(n_rays)


def _port_megakernel(scene, cam, film, sampler, max_depth):
    blocks, valids = pixel_blocks(film, RES * RES, device="cpu")
    wave = make_wave_renderer(scene, cam, film, sampler, "path", max_depth=max_depth)
    fs, st = wave(film.init_state("cpu"), torch.arange(SPP), blocks[0], valids[0])
    return film.get_image(fs).numpy(), float(st["rays"])


def _port_wavefront(scene, cam, film, sampler, max_depth, block):
    blocks, valids = pixel_blocks(film, block, device="cpu")
    wave = make_wavefront_renderer(scene, cam, film, sampler, max_depth=max_depth)
    fs, st = wave(film.init_state("cpu"), torch.arange(SPP), blocks[0], valids[0])
    return film.get_image(fs).numpy(), float(st["rays"])


def test_megakernel_matches_reference(wavefront_scene):
    (jscene, jcam, jfilm), (scene, cam, film) = wavefront_scene
    ref, ref_rays = _jax_megakernel(jscene, jcam, jfilm, JaxIndependent(SPP), DEPTH)
    img, rays = _port_megakernel(scene, cam, film, IndependentSampler(SPP), DEPTH)
    assert np.isfinite(img).all() and img.mean() > 0.01
    close = np.isclose(img, ref, rtol=1e-3, atol=1e-4).all(axis=-1)
    print(f"pixels beyond rtol 1e-3 / atol 1e-4: {int((~close).sum())} of {close.size}")
    assert close.all()
    assert rays == ref_rays


def _rel(a, b):
    return np.abs(a - b).max() / max(b.max(), 1e-6)


def test_megakernel_matches_wavefront(wavefront_scene):
    """tests/test_wavefront.py::test_wavefront_matches_megakernel in the
    port: the same estimator with the same draws."""
    _, (scene, cam, film) = wavefront_scene
    mk, mk_rays = _port_megakernel(scene, cam, film, IndependentSampler(SPP), DEPTH)
    wf, wf_rays = _port_wavefront(scene, cam, film, IndependentSampler(SPP), DEPTH, RES * RES)
    assert np.isfinite(wf).all() and wf.mean() > 0.01
    assert _rel(wf, mk) < 2e-3
    assert wf_rays == mk_rays


def test_render_dispatch_and_padding(wavefront_scene):
    """render(wavefront=False) over 3 blocks of 1000 lanes (the last with
    904 padded lanes) equals the one-block megakernel image: the padded
    lanes are dropped by the film, not added to any pixel."""
    _, (scene, cam, film) = wavefront_scene
    one, _ = _port_megakernel(scene, cam, film, IndependentSampler(SPP), DEPTH)
    img, state, stats = torch_render(scene, cam, film, IndependentSampler(SPP), spp=SPP,
                                     max_depth=DEPTH, wave_spp=2, pixel_block=1000,
                                     wavefront=False, collect_stats=True)
    assert (state.weight_sum.numpy() == SPP).all()
    assert np.array_equal(img.numpy(), one)
    assert stats["rays"] > 0 and "iters" not in stats


def test_megakernel_matches_wavefront_in_fog():
    """tests/test_media.py::TestWavefrontMedium in the port."""
    res = 24
    ct = JaxCameraTransform(JaxTransform.look_at(jnp.array([0.0, 0.0, -4.0]), jnp.zeros(3),
                                                 jnp.array([0.0, 1.0, 0.0])))
    jcam = JaxPerspective(ct, (res, res), fov=45.0)
    jscene = jax_build_scene(
        spheres=[
            {"radius": 1.0, "material_id": 0},
            {"radius": 0.3, "material_id": 1, "area_light_id": 0,
             "object_to_world": JaxTransform.translate(jnp.array([0.0, 2.0, 0.0]))},
        ],
        materials=[
            {"kind": jmtl.DIFFUSE, "reflectance": [0.6, 0.5, 0.4]},
            {"kind": jmtl.DIFFUSE, "reflectance": [0.0, 0.0, 0.0]},
        ],
        lights=[{"kind": jlt.AREA, "spectrum": JaxConstant(30.0), "shape_kind": 0,
                 "shape_idx": 1}],
        media=[{"sigma_a": 0.05, "sigma_s": 0.2, "g": 0.3}],
        camera_medium=0,
        render_from_world=jcam.camera_transform.render_from_world(),
    )
    scene = _port_scene(jscene)
    cam, film = _port_camera(jcam, 45.0), _port_film((res, res))
    blocks, valids = pixel_blocks(film, res * res, device="cpu")
    sampler = IndependentSampler(SPP)
    mk = make_wave_renderer(scene, cam, film, sampler, "path", max_depth=4)
    img_mk = film.get_image(mk(film.init_state("cpu"), torch.arange(SPP), blocks[0],
                               valids[0])[0]).numpy()
    wf = make_wavefront_renderer(scene, cam, film, sampler, max_depth=4)
    img_wf = film.get_image(wf(film.init_state("cpu"), torch.arange(SPP), blocks[0],
                               valids[0])[0]).numpy()
    assert np.isfinite(img_wf).all() and img_wf.mean() > 1e-3
    assert _rel(img_wf, img_mk) < 2e-3


INTERFACE = """
MakeNamedMedium "ink" "string type" "homogeneous"
  "rgb sigma_a" [0.4 0.2 0.1] "rgb sigma_s" [0.2 0.2 0.2]
LookAt 0 0 -4  0 0 0  0 1 0
Camera "perspective" "float fov" [40]
Film "rgb" "integer xresolution" [16] "integer yresolution" [16]
Sampler "independent" "integer pixelsamples" [4]
Integrator "volpath" "integer maxdepth" [5]
WorldBegin
Material "diffuse" "rgb reflectance" [0.3 0.3 0.3]
AttributeBegin
MediumInterface "ink" ""
Material "none"
Shape "trianglemesh"
  "point3 P" [-3 -3 0.5  -3 3 0.5  3 3 0.5  3 -3 0.5]
  "integer indices" [0 1 2 0 2 3]
Shape "trianglemesh"
  "point3 P" [-3 -3 1.5  3 -3 1.5  3 3 1.5  -3 3 1.5]
  "integer indices" [0 1 2 0 2 3]
AttributeEnd
AttributeBegin
AreaLightSource "diffuse" "float scale" [8]
Shape "trianglemesh"
  "point3 P" [-6 -6 3  -6 6 3  6 6 3  6 -6 3]
  "integer indices" [0 1 2 0 2 3]
AttributeEnd
"""


def test_megakernel_matches_wavefront_interfaces():
    """tests/test_media.py::TestInterfaceMedia's wavefront-against-
    megakernel case in the port, read by the port's loader."""
    b = SceneBuilder()
    parse_str(INTERFACE, b)
    job = b.create(device="cpu")
    assert job.scene.has_interface_media
    assert isinstance(job.sampler, IndependentSampler)
    blocks, valids = pixel_blocks(job.film, 16 * 16, device="cpu")
    idx = torch.arange(SPP)
    mk = make_wave_renderer(job.scene, job.camera, job.film, job.sampler, "path", max_depth=5)
    img_mk = job.film.get_image(mk(job.film.init_state("cpu"), idx, blocks[0],
                                   valids[0])[0]).numpy()
    wf = make_wavefront_renderer(job.scene, job.camera, job.film, job.sampler, max_depth=5)
    img_wf = job.film.get_image(wf(job.film.init_state("cpu"), idx, blocks[0],
                                   valids[0])[0]).numpy()
    assert np.isfinite(img_wf).all() and img_wf.mean() > 1e-3
    assert _rel(img_wf, img_mk) < 2e-3


def test_scan_wave_renderer_and_full_image_pixels(wavefront_scene):
    """make_scan_wave_renderer over every block equals the per-block
    megakernel waves; full_image_pixels equals the reference's."""
    from shimmer_tpu.render import full_image_pixels as jax_full_image_pixels
    from shimmer_tpu_torch.render import full_image_pixels, make_scan_wave_renderer

    (_, _, jfilm), (scene, cam, film) = wavefront_scene
    np.testing.assert_array_equal(full_image_pixels(film, device="cpu").numpy(),
                                  np.asarray(jax_full_image_pixels(jfilm)))
    blocks, valids = pixel_blocks(film, 1000, device="cpu")
    sampler = IndependentSampler(2)
    scan = make_scan_wave_renderer(scene, cam, film, sampler, "path", max_depth=2)
    fs = scan(film.init_state("cpu"), torch.arange(2), blocks, valids)
    wave = make_wave_renderer(scene, cam, film, sampler, "path", max_depth=2)
    fs2 = film.init_state("cpu")
    for b in range(blocks.shape[0]):
        fs2, _ = wave(fs2, torch.arange(2), blocks[b], valids[b])
    assert torch.equal(fs.rgb_sum, fs2.rgb_sum) and torch.equal(fs.weight_sum, fs2.weight_sum)


def test_li_path_alive_mask_stats_and_remat(wavefront_scene):
    """Dead lanes (alive_mask) trace nothing and return zero; the rays
    count only live lanes; since the gradient slice, remat True and "full"
    give the same estimate and rays bit for bit (their gradients are held
    in tests/test_torch_grad_remat.py), and an unknown form raises."""
    from shimmer_tpu_torch.film.filters import get_camera_sample
    from shimmer_tpu_torch.integrators.path import li_path

    _, (scene, cam, film) = wavefront_scene
    sampler = IndependentSampler(1)
    px = torch.stack(torch.meshgrid(torch.arange(16), torch.arange(16), indexing="xy"),
                     -1).reshape(-1, 2).to(torch.int32)
    s = sampler.start_pixel_sample(px, torch.tensor(0))
    u, s = sampler.get_1d(s)
    swl = film.sample_wavelengths(u)
    uf, s = sampler.get_pixel_2d(s)
    ul, s = sampler.get_2d(s)
    p_film, _, ul = get_camera_sample(film.filter, px + 16, uf, ul)
    ray = cam.generate_ray(p_film, ul)
    mask = torch.arange(256) % 2 == 0
    l_all, st_all = li_path(scene, ray, swl, sampler, s, 3, return_stats=True)
    l_half, st_half = li_path(scene, ray, swl, sampler, s, 3, return_stats=True, alive_mask=mask)
    assert (l_half[~mask] == 0).all()
    assert torch.equal(l_half[mask], l_all[mask])
    assert 0 < float(st_half["rays"]) < float(st_all["rays"])
    for remat in (True, "full"):
        l_r, st_r = li_path(scene, ray, swl, sampler, s, 3, return_stats=True, remat=remat)
        assert torch.equal(l_r, l_all) and torch.equal(st_r["rays"], st_all["rays"])
    with pytest.raises(ValueError, match="remat"):
        li_path(scene, ray, swl, sampler, s, 3, remat="scan")


def test_film_drops_samples_outside_the_image():
    """RgbFilm.add_samples drops a lane whose pixel lies outside the image
    (where render_pixel_samples sends padded lanes), whatever it carries:
    it is not clamped onto an edge pixel."""
    from shimmer_tpu_torch.spectra.sampled import SampledWavelengths

    film = _port_film((4, 3))
    px = torch.tensor([[1, 2], [4, 3], [3, 2], [-1, 0], [0, 3]], dtype=torch.int32)
    lam = torch.full((5, 4), 550.0)
    swl = SampledWavelengths(lam=lam, pdf=torch.full((5, 4), 0.01))
    fs = film.add_samples(film.init_state("cpu"), px, torch.ones((5, 4)), swl, torch.ones(5))
    w = fs.weight_sum.numpy()
    assert w.sum() == 2.0 and w[2, 1] == 1.0 and w[2, 3] == 1.0
    assert (fs.rgb_sum.numpy()[w == 0] == 0).all()
