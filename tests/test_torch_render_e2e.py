"""tests/test_render_e2e.py's analytic cases in the port, on the CPU, at
that file's sizes, sample counts, seeds and limits: the gray furnace
against L = rho * L_env, simplepath and path agreeing on an area-lit
sphere, ZSobol agreeing with the independent sampler in the mean, a light
below the sphere leaving its top dark, a point light's inverse-square
falloff, and the coated-diffuse white furnace within [0.85, 1.02].
(The white furnace per estimator is in tests/test_torch_estimators.py.)"""

import os

os.environ.setdefault("OMP_NUM_THREADS", "1")

import numpy as np
import torch

from shimmer_tpu_torch.cameras import CameraTransform, PerspectiveCamera
from shimmer_tpu_torch.color.colorspace import get_named_color_space
from shimmer_tpu_torch.film.film import PixelSensor, RgbFilm
from shimmer_tpu_torch.film.filters import BoxFilter
from shimmer_tpu_torch.lights import lights as lt
from shimmer_tpu_torch.materials import material as mtl
from shimmer_tpu_torch.ops.transform import Transform
from shimmer_tpu_torch.render import render
from shimmer_tpu_torch.samplers import IndependentSampler, ZSobolSampler
from shimmer_tpu_torch.scene_builder import build_scene
from shimmer_tpu_torch.spectra.spectrum import ConstantSpectrum

torch.set_num_threads(1)


def _make_camera_film(res=64, fov=45.0, z=-4.0):
    cs = get_named_color_space("srgb")
    ct = CameraTransform(Transform.look_at([0.0, 0.0, z], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]))
    cam = PerspectiveCamera(ct, (res, res), fov=fov)
    film = RgbFilm((res, res), BoxFilter(), PixelSensor(cs), cs)
    return cam, film, cs


def _scene(cam, spheres, materials, lights):
    r2w = cam.camera_transform.render_from_world()
    for s in spheres:
        s["object_to_render"] = r2w @ s.pop("object_to_world", Transform.identity())
    return build_scene(None, materials=materials, lights=lights, spheres=spheres,
                       render_from_world=r2w, device="cpu")


def _furnace_scene(albedo, cam, cs, material=None):
    return _scene(
        cam, [{"radius": 1.0, "material_id": 0}],
        [material or {"kind": mtl.DIFFUSE, "reflectance": albedo}],
        [{"kind": lt.UNIFORM_INFINITE, "spectrum": cs.illuminant, "photometric": True}],
    )


def _area_light_scene(cam, light_y=2.0):
    return _scene(
        cam,
        [{"radius": 1.0, "material_id": 0},
         {"radius": 0.3, "material_id": 1, "area_light_id": 0,
          "object_to_world": Transform.translate([0.0, light_y, 0.0])}],
        [{"kind": mtl.DIFFUSE, "reflectance": [0.8, 0.4, 0.2]},
         {"kind": mtl.DIFFUSE, "reflectance": [0.0, 0.0, 0.0]}],
        [{"kind": lt.AREA, "spectrum": ConstantSpectrum(40.0), "shape_kind": 0, "shape_idx": 1}],
    )


def test_gray_furnace_matches_analytic():
    rho = 0.5
    cam, film, cs = _make_camera_film(res=32)
    scene = _furnace_scene([rho, rho, rho], cam, cs)
    image, _ = render(scene, cam, film, IndependentSampler(128), integrator="path", spp=128,
                      max_depth=6, wave_spp=64)
    img = image.numpy()
    np.testing.assert_allclose(img[12:20, 12:20].mean(axis=(0, 1)), rho, atol=0.03)
    np.testing.assert_allclose(img[:3, :3].mean(axis=(0, 1)), 1.0, atol=0.035)


def test_integrators_agree():
    cam, film, _ = _make_camera_film(res=48, z=-4.0)
    scene = _area_light_scene(cam)
    spp = 256
    imgs = {}
    for integ in ["simplepath", "path"]:
        image, _ = render(scene, cam, film, IndependentSampler(spp, seed=7), integrator=integ,
                          spp=spp, max_depth=5, wave_spp=128)
        imgs[integ] = image.numpy()
    a, b = imgs["simplepath"], imgs["path"]
    assert np.all(np.isfinite(a)) and np.all(np.isfinite(b))
    assert a.max() > 0.05
    mean_err = np.abs(a - b).mean() / max(a.mean(), 1e-6)
    assert mean_err < 0.15, f"integrator disagreement {mean_err}"


def test_zsobol_unbiased():
    cam, film, _ = _make_camera_film(res=32, z=-4.0)
    scene = _area_light_scene(cam)
    spp = 64
    ind, _ = render(scene, cam, film, IndependentSampler(spp), "path", spp=spp, max_depth=5,
                    wave_spp=64)
    zs, _ = render(scene, cam, film, ZSobolSampler(spp, (32, 32)), "path", spp=spp, max_depth=5,
                   wave_spp=64)
    a, b = ind.numpy(), zs.numpy()
    assert np.all(np.isfinite(b))
    np.testing.assert_allclose(a.mean(), b.mean(), rtol=0.1)


def test_shadowing():
    cam, film, _ = _make_camera_film(res=32, z=-4.0)
    scene = _area_light_scene(cam, light_y=-2.0)
    image, _ = render(scene, cam, film, IndependentSampler(32), "path", spp=32, max_depth=2,
                      wave_spp=32)
    img = image.numpy()
    top = img[4:10, 12:20].mean()
    bottom = img[22:28, 12:20].mean()
    assert bottom > 4.0 * max(top, 1e-5), (top, bottom)


def test_inverse_square():
    cam, film, _ = _make_camera_film(res=16, z=-5.0)
    means = []
    for dist in (8.0, 16.0):
        scene = _scene(
            cam, [{"radius": 1.0, "material_id": 0}],
            [{"kind": mtl.DIFFUSE, "reflectance": [1.0, 1.0, 1.0]}],
            [{"kind": lt.POINT, "spectrum": ConstantSpectrum(100.0),
              "position": (0.0, 0.0, -1.0 - dist)}],
        )
        img, _ = render(scene, cam, film, IndependentSampler(64), "path", spp=64, max_depth=1,
                        wave_spp=64)
        means.append(img.numpy()[7:9, 7:9].mean())
    ratio = means[0] / means[1]
    assert abs(ratio - 4.0) < 0.25, ratio


def test_coated_diffuse_white_furnace_bound():
    cam, film, cs = _make_camera_film(res=24)
    scene = _furnace_scene(None, cam, cs, material={
        "kind": mtl.COATED_DIFFUSE, "reflectance": [1.0, 1.0, 1.0], "uroughness": 0.0,
        "vroughness": 0.0, "eta_float": 1.5, "thickness": 1e-4})
    img, _ = render(scene, cam, film, IndependentSampler(64, seed=0), "path", spp=64,
                    max_depth=8, wave_spp=32)
    a = img.numpy()
    assert np.isfinite(a).all()
    center = a[10:14, 10:14].mean()
    assert 0.85 < center < 1.02, center
