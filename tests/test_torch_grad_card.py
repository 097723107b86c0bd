"""Gradients on the card:

* tests/test_grad.py::TestGradients' four scenes (the texture case twice:
  one texel, and the whole atlas) at its sizes, seed, steps and
  tolerances: the card's AD against its own central finite difference,
  and within 1e-3 of the CPU's AD;
* the bench scene in several pixel blocks through the megakernel with
  ``li_path(remat="full")``: exactly n_blocks x spp x (1 + depth) v1
  launches forward and n_blocks x spp x (1 + 2 x depth) with the
  backward (each bounce's trace runs again in its recompute), the
  gradient finite and nonzero;
* tests/test_grad.py::TestReplayWavefrontGradients' scene at its sizes:
  the replay wavefront's value against the wavefront's and its gradient
  against the megakernel's on the card, both against the CPU's;
* the replay backward at the gradient cell's settings (the bench scene
  at 1280x720, 1 spp, depth 5, in 2^17-pixel blocks): exactly the
  wavefront's iterations of launches forward, and n_blocks x spp x (1 +
  depth) more in the backward, each block's paths replayed by the
  megakernel; the gradient finite and nonzero.

Marked ``card``; run on the card as tests/card_checks.py says.
"""

import dataclasses

import numpy as np
import pytest
import torch

from card_checks import CONFIGS, MAX_DEPTH, SMALL_RES, card, launches, reset_launches  # noqa: F401
from shimmer_tpu_torch import render as render_module
from shimmer_tpu_torch.bench_scene import BENCH_RESOLUTION, BENCH_TRIS, build_bench_scene
from shimmer_tpu_torch.cameras import CameraTransform, PerspectiveCamera
from shimmer_tpu_torch.color.colorspace import get_named_color_space
from shimmer_tpu_torch.film.film import PixelSensor, RgbFilm
from shimmer_tpu_torch.film.filters import BoxFilter, get_camera_sample
from shimmer_tpu_torch.integrators.path import li_path
from shimmer_tpu_torch.lights import lights as lt
from shimmer_tpu_torch.materials import material as mtl
from shimmer_tpu_torch.ops.transform import Transform
from shimmer_tpu_torch.render import make_wavefront_renderer
from shimmer_tpu_torch.samplers import IndependentSampler, ZSobolSampler
from shimmer_tpu_torch.scene_builder import build_scene
from shimmer_tpu_torch.spectra.spectrum import ConstantSpectrum
from shimmer_tpu_torch.textures import textures as tx

pytestmark = pytest.mark.card

# tests/test_grad.py's sizes and seed; the card's AD against the CPU's.
GRAD_RES, GRAD_SPP, GRAD_DEPTH, GRAD_SEED = 12, 32, 3, 7
GRAD_RTOL = 1e-3
# tests/test_grad.py::TestReplayWavefrontGradients' sizes.
REPLAY_RES, REPLAY_SPP, REPLAY_DEPTH = 12, 2, 3
REPLAY_VALUE_RTOL = 1e-5  # replay value against the wavefront's
REPLAY_GRAD_RTOL = 1e-4   # replay gradient against the megakernel's (atomic adds)
# The remat backward's blocks: 64x48 pixels in blocks of 1,024, 1 spp.
BLOCK_PIXELS = 1024


def _grad_sphere_and_light(albedo, spectrum, scale):
    return dict(
        spheres=[{"radius": 1.0, "material_id": 0},
                 {"radius": 0.3, "material_id": 1, "area_light_id": 0,
                  "object_to_world": Transform.translate([0.0, 2.0, 0.0])}],
        materials=[{"kind": mtl.DIFFUSE, "reflectance": albedo},
                   {"kind": mtl.DIFFUSE, "reflectance": [0.0, 0.0, 0.0]}],
        lights=[{"kind": lt.AREA, "spectrum": ConstantSpectrum(spectrum), "scale": scale,
                 "shape_kind": 0, "shape_idx": 1}])


def _grad_in_env(material):
    cs = get_named_color_space("srgb")
    return dict(
        spheres=[{"radius": 1.0, "material_id": 0}], materials=[material],
        lights=[{"kind": lt.UNIFORM_INFINITE, "spectrum": cs.illuminant, "photometric": True}])


def _grad_textured(device):
    b = tx.TextureBuilder()
    tid = b.add_image(np.full((4, 4, 3), 0.5, np.float32), is_spectrum=True,
                      filter_kind=tx.FILTER_POINT)
    return dict(_grad_in_env({"kind": mtl.DIFFUSE, "reflectance": [0.5, 0.5, 0.5],
                              "tex_reflectance": tid}), textures=b.build(device=device))


# tests/test_grad.py::TestGradients' cases: scene, parameter (table,
# fields, index; the texel row is relative to the level-0 offset; "add"
# shifts instead of setting), finite-difference step and tolerances, and
# its bound on |AD| (None: AD > 0).
GRAD_CASES = {
    "diffuse_reflectance": (lambda d: _grad_sphere_and_light([0.6, 0.5, 0.4], 20.0, 1.0),
                            ("materials", ("reflectance",), (0, 1), False),
                            dict(h=1e-2, rtol=2e-2, atol=0.0), 1e-6),
    "emission_scale": (lambda d: _grad_sphere_and_light([0.7, 0.7, 0.7], 1.0, 20.0),
                       ("lights", ("scale",), (0,), False), dict(h=0.5, rtol=1e-3, atol=0.0),
                       None),
    "conductor_roughness": (
        lambda d: _grad_in_env({"kind": mtl.CONDUCTOR, "uroughness": 0.09, "vroughness": 0.09}),
        ("materials", ("uroughness", "vroughness"), (0,), False),
        dict(h=1e-2, rtol=5e-2, atol=1e-4), 1e-6),
    "texture_texel": (_grad_textured, ("textures", ("atlas",), (5, 2), False),
                      dict(h=5e-3, rtol=5e-2, atol=1e-7), 0.0),
    "texture_whole_atlas": (_grad_textured, ("textures", ("atlas",), (slice(0, 16), 2), True),
                            dict(h=5e-3, rtol=5e-2, atol=0.0), 1e-6),
}


def grad_setup(case: str, device):
    """A case's f(theta) on ``device``: the mean per-lane radiance of
    li_path over every pixel and sample (one call, a lane each), with the
    parameter set to theta; and theta's value in the scene."""
    build, (table, fields, index, add), _, _ = GRAD_CASES[case]
    cs = get_named_color_space("srgb")
    cam = PerspectiveCamera(CameraTransform(Transform.look_at([0.0, 0.0, -4.0], [0.0, 0.0, 0.0],
                                                              [0.0, 1.0, 0.0])),
                            (GRAD_RES, GRAD_RES), fov=45.0)
    film = RgbFilm((GRAD_RES, GRAD_RES), BoxFilter(), PixelSensor(cs), cs)
    scene = build_scene(None, render_from_world=cam.camera_transform.render_from_world(),
                        device=device, **build(device))
    if table == "textures":
        off = int(scene.textures.level0_offset[0])
        row = index[0]
        index = (slice(off + row.start, off + row.stop) if isinstance(row, slice) else off + row,
                 index[1])
    ys, xs = torch.meshgrid(torch.arange(GRAD_RES, dtype=torch.int32),
                            torch.arange(GRAD_RES, dtype=torch.int32), indexing="ij")
    pixels = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)
    # Every pixel's every sample as one lane of one li_path call.
    pixel_xy = pixels.repeat(GRAD_SPP, 1).to(device)
    sample_index = torch.arange(GRAD_SPP).repeat_interleave(pixels.shape[0]).to(device)
    sampler = IndependentSampler(GRAD_SPP, seed=GRAD_SEED)

    def f(theta):
        tab = getattr(scene, table)
        new = {}
        for k in fields:
            base = getattr(tab, k)
            mask = torch.zeros(base.shape, dtype=torch.bool)
            mask[index] = True
            mask = mask.to(device)
            new[k] = (base + torch.where(mask, theta, 0.0) if add
                      else torch.where(mask, theta, base))
        sc = dataclasses.replace(scene, **{table: dataclasses.replace(tab, **new)})
        s_state = sampler.start_pixel_sample(pixel_xy, sample_index)
        u_lam, s_state = sampler.get_1d(s_state)
        swl = film.sample_wavelengths(u_lam)
        u_f, s_state = sampler.get_pixel_2d(s_state)
        u_l, s_state = sampler.get_2d(s_state)
        p_film, _, u_l = get_camera_sample(film.filter, pixel_xy, u_f, u_l)
        ray = cam.generate_ray(p_film, u_l)
        return torch.mean(li_path(sc, ray, swl, sampler, s_state, GRAD_DEPTH))

    base = getattr(getattr(scene, table), fields[0])
    theta0 = 0.0 if add else float(base[index])
    return f, theta0


def grad_ad(case: str, device) -> float:
    f, theta0 = grad_setup(case, device)
    th = torch.tensor(theta0, device=device, requires_grad=True)
    (g,) = torch.autograd.grad(f(th), th)
    return float(g)


def grad_fd(case: str, device) -> float:
    f, theta0 = grad_setup(case, device)
    h = GRAD_CASES[case][2]["h"]
    th = torch.tensor(theta0, device=device)
    with torch.no_grad():
        return float((f(th + h) - f(th - h)) / (2.0 * h))


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_ad_on_the_card_matches_fd_and_the_cpu(card, case):
    _, _, fd, bound = GRAD_CASES[case]
    ad, fd_g, cpu_ad = grad_ad(case, card), grad_fd(case, card), grad_ad(case, "cpu")
    assert np.isfinite(ad)
    assert abs(ad - fd_g) <= fd["atol"] + fd["rtol"] * abs(fd_g), (ad, fd_g)
    assert abs(ad - cpu_ad) <= GRAD_RTOL * abs(cpu_ad), (ad, cpu_ad)
    assert ad > 0 if bound is None else abs(ad) > bound


def bench_with_floor_leaf(resolution, dev):
    """The bench scene on ``dev`` under v1 with the floor's reflectance
    coefficients (material 1) a leaf: (scene, camera, film, leaf)."""
    scene, cam, film = build_bench_scene(BENCH_TRIS, resolution, device="cpu")
    scene = scene.to(dev)
    scene = dataclasses.replace(scene, triangles=scene.triangles.with_traverse(CONFIGS["v1"]))
    floor = scene.materials.reflectance[1].clone().requires_grad_(True)
    refl = torch.cat([scene.materials.reflectance[:1], floor[None],
                      scene.materials.reflectance[2:]])
    scene = dataclasses.replace(scene, materials=dataclasses.replace(scene.materials,
                                                                     reflectance=refl))
    return scene, cam, film, floor


def test_full_remat_traces_each_bounce_again_in_the_backward(card):
    """The gradient of the image mean with respect to the floor's
    reflectance coefficients."""
    scene, cam, film, floor = bench_with_floor_leaf(SMALL_RES, card)
    n_blocks = -(-SMALL_RES[0] * SMALL_RES[1] // BLOCK_PIXELS)
    assert n_blocks > 1
    reset_launches()
    img, _ = render_module.render(scene, cam, film, ZSobolSampler(1, SMALL_RES), spp=1,
                                  max_depth=MAX_DEPTH, wave_spp=1, pixel_block=BLOCK_PIXELS,
                                  wavefront=False, integrator_options={"remat": "full"})
    assert launches("v1") == n_blocks * (1 + MAX_DEPTH)
    (grad,) = torch.autograd.grad(img.mean(), floor)
    assert launches("v1") == n_blocks * (1 + 2 * MAX_DEPTH)
    grad = grad.cpu().numpy()
    assert np.isfinite(grad).all() and np.abs(grad).sum() > 0


def replay_values(device) -> dict:
    """The value and the gradient with respect to reflectance
    coefficient (0, 1) of the mean film sum, through the replay wavefront,
    the megakernel and (value only) the wavefront."""
    cs = get_named_color_space("srgb")
    cam = PerspectiveCamera(CameraTransform(Transform.look_at([0.0, 0.0, -4.0], [0.0, 0.0, 0.0],
                                                              [0.0, 1.0, 0.0])),
                            (REPLAY_RES, REPLAY_RES), fov=45.0)
    film = RgbFilm((REPLAY_RES, REPLAY_RES), BoxFilter(), PixelSensor(cs), cs)
    scene = build_scene(None, render_from_world=cam.camera_transform.render_from_world(),
                        device=device, **_grad_sphere_and_light([0.6, 0.5, 0.4], 20.0, 1.0))
    sampler = IndependentSampler(REPLAY_SPP)
    pixel_xy = render_module.full_image_pixels(film, device)
    valid = torch.ones(pixel_xy.shape[0], dtype=torch.bool, device=device)
    idx = torch.arange(REPLAY_SPP, device=device)
    mask = torch.zeros(scene.materials.reflectance.shape, dtype=torch.bool)
    mask[0, 1] = True
    mask = mask.to(device)
    theta0 = float(scene.materials.reflectance[0, 1])

    def with_theta(theta):
        refl = torch.where(mask, theta, scene.materials.reflectance)
        return dataclasses.replace(scene, materials=dataclasses.replace(scene.materials,
                                                                        reflectance=refl))

    def value_grad(render_fn):
        th = torch.tensor(theta0, device=device, requires_grad=True)
        v = render_fn(with_theta(th)).rgb_sum.sum() / pixel_xy.shape[0]
        (g,) = torch.autograd.grad(v, th)
        return float(v.detach()), float(g)

    replay = render_module.make_replay_wavefront_renderer(scene, cam, film, sampler,
                                                          max_depth=REPLAY_DEPTH)
    out = {}
    out["replay_value"], out["replay_grad"] = value_grad(
        lambda sc: replay(sc, film.init_state(device), idx, pixel_xy, valid))
    out["megakernel_value"], out["megakernel_grad"] = value_grad(
        lambda sc: render_module.render_pixel_samples(
            sc, cam, film, sampler, li_path, {}, film.init_state(device), idx, pixel_xy,
            pixel_valid=valid, max_depth=REPLAY_DEPTH)[0])
    fs, _ = make_wavefront_renderer(scene, cam, film, sampler, max_depth=REPLAY_DEPTH)(
        film.init_state(device), idx, pixel_xy, valid)
    out["wavefront_value"] = float(fs.rgb_sum.sum() / pixel_xy.shape[0])
    return out


def test_replay_on_the_card_matches_the_wavefront_the_megakernel_and_the_cpu(card):
    got, cpu = replay_values(card), replay_values("cpu")
    assert (abs(got["replay_value"] - got["wavefront_value"])
            <= REPLAY_VALUE_RTOL * abs(got["wavefront_value"]))
    assert got["replay_grad"] != 0.0
    assert (abs(got["replay_grad"] - got["megakernel_grad"])
            <= REPLAY_GRAD_RTOL * abs(got["megakernel_grad"]))
    for key in ("replay_value", "replay_grad"):
        assert abs(got[key] - cpu[key]) <= GRAD_RTOL * abs(cpu[key]), key


# The gradient cell's steps: spp and pixel block.
CELL_SPP, CELL_BLOCK = 1, 1 << 17


def test_replay_backward_at_the_cell_size_replays_each_block(card):
    """The gradient of the image mean with respect to the floor's
    reflectance coefficients, through the replay wavefront over every
    pixel block."""
    scene, cam, film, floor = bench_with_floor_leaf(BENCH_RESOLUTION, card)
    wave = render_module.make_replay_wavefront_renderer(
        scene, cam, film, ZSobolSampler(CELL_SPP, BENCH_RESOLUTION), max_depth=MAX_DEPTH,
        with_stats=True)
    blocks, valids = render_module.pixel_blocks(film, CELL_BLOCK, card)
    n_blocks = blocks.shape[0]
    assert n_blocks > 1
    idx = torch.arange(CELL_SPP, device=card)
    reset_launches()
    state, iters = film.init_state(card), 0
    for b in range(n_blocks):
        state, st = wave(scene, state, idx, blocks[b], valids[b])
        iters += int(st["iters"])
    loss = film.get_image(state).mean()
    assert launches("v1") == iters
    (grad,) = torch.autograd.grad(loss, floor)
    assert launches("v1") == iters + n_blocks * CELL_SPP * (1 + MAX_DEPTH)
    grad = grad.cpu().numpy()
    assert np.isfinite(grad).all() and np.abs(grad).sum() > 0
