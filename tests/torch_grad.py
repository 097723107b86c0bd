"""Helpers and cases of the gradient tests of the port
(tests/test_torch_grad_*.py).

Each case differentiates the mean per-lane radiance of ``li_path`` over
every pixel and sample at a fixed sampler seed (common random numbers),
as tests/test_grad.py's ``_mean_radiance`` does, with respect to one scene
parameter.  The scene is built by the reference and carried across with
``scene_from_numpy``; the camera is built by each package from the same
matrix.  ``CASES`` holds tests/test_grad.py::TestGradients' four cases
(the texture case twice: one texel, and the whole atlas), each checked
two ways:

- the port's AD against the port's own central finite difference, at
  tests/test_grad.py's sizes (12x12, 32 spp, depth 3), ``h``, ``rtol``
  and ``atol`` (tests/test_torch_grad_fd.py);
- the port's AD against the reference's ``jax.grad`` run op by op
  (``jax.disable_jit``: jitted, XLA contracts FMAs) at 8x8, 2 spp, depth
  2, within rtol ``AD_RTOL`` = 1e-3, and the forward values within 1e-6
  (tests/test_torch_grad_reference.py; the two have agreed to the last
  bit where this was written).  Op by op, the reference's first AD in a
  process spends ~25 s compiling its primitives, so these cases share one
  file.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from shimmer_tpu.cameras import CameraTransform as JaxCameraTransform
from shimmer_tpu.cameras import PerspectiveCamera as JaxPerspective
from shimmer_tpu.color.colorspace import get_named_color_space as jax_colorspace
from shimmer_tpu.film.film import PixelSensor as JaxSensor
from shimmer_tpu.film.film import RgbFilm as JaxFilm
from shimmer_tpu.film.filters import BoxFilter as JaxBox
from shimmer_tpu.film.filters import get_camera_sample as jax_camera_sample
from shimmer_tpu.integrators.path import li_path as jax_li_path
from shimmer_tpu.lights import lights as jlt
from shimmer_tpu.materials import material as jmtl
from shimmer_tpu.ops.transform import Transform as JaxTransform
from shimmer_tpu.samplers import IndependentSampler as JaxIndependent
from shimmer_tpu.scene_builder import build_scene as jax_build_scene
from shimmer_tpu.spectra.spectrum import ConstantSpectrum as JaxConstant
from shimmer_tpu.textures import textures as jtx
from shimmer_tpu_torch.cameras import CameraTransform, PerspectiveCamera
from shimmer_tpu_torch.color.colorspace import get_named_color_space
from shimmer_tpu_torch.convert import scene_from_numpy
from shimmer_tpu_torch.film.film import PixelSensor, RgbFilm
from shimmer_tpu_torch.film.filters import BoxFilter, get_camera_sample
from shimmer_tpu_torch.integrators.path import li_path
from shimmer_tpu_torch.ops.transform import Transform
from shimmer_tpu_torch.samplers import IndependentSampler
from torch_parity import jax_scene_to_numpy

FD_SIZE = (12, 32, 3)    # RES, SPP, MAX_DEPTH of tests/test_grad.py
SMALL = (8, 2, 2)        # RES, SPP, MAX_DEPTH of the op-by-op reference
AD_RTOL = 1e-3


def jax_camera(res, eye=(0.0, 0.0, -4.0), look=(0.0, 0.0, 0.0), fov=45.0):
    ct = JaxCameraTransform(JaxTransform.look_at(jnp.array(eye), jnp.array(look),
                                                 jnp.array([0.0, 1.0, 0.0])))
    return JaxPerspective(ct, (res, res), fov=fov)


def jax_film(res):
    cs = jax_colorspace("srgb")
    return JaxFilm((res, res), JaxBox(), JaxSensor(cs), cs)


def port_camera(jcam, fov=45.0):
    ct = jcam.camera_transform
    w2c = ct.world_from_render @ ct.render_from_camera
    m = Transform(m=np.asarray(w2c.m), m_inv=np.asarray(w2c.m_inv))
    return PerspectiveCamera(CameraTransform(m), jcam.resolution, fov=fov)


def port_film(res):
    cs = get_named_color_space("srgb")
    return RgbFilm((res, res), BoxFilter(), PixelSensor(cs), cs)


def port_scene(jscene):
    return scene_from_numpy(*jax_scene_to_numpy(jscene), device="cpu")


def _pixels_torch(res):
    ys, xs = torch.meshgrid(torch.arange(res, dtype=torch.int32),
                            torch.arange(res, dtype=torch.int32), indexing="ij")
    return torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)


def port_mean_radiance(scene, cam, film, spp, max_depth, seed=7, remat=False):
    """The port's mean per-lane radiance over every pixel and sample."""
    res = film.resolution[0]
    sampler = IndependentSampler(spp, seed=seed)
    pixel_xy = _pixels_torch(res)
    vals = []
    for i in range(spp):
        s_state = sampler.start_pixel_sample(pixel_xy, torch.tensor(i))
        u_lam, s_state = sampler.get_1d(s_state)
        swl = film.sample_wavelengths(u_lam)
        u_f, s_state = sampler.get_pixel_2d(s_state)
        u_l, s_state = sampler.get_2d(s_state)
        p_film, _, u_l = get_camera_sample(film.filter, pixel_xy, u_f, u_l)
        ray = cam.generate_ray(p_film, u_l)
        vals.append(torch.mean(li_path(scene, ray, swl, sampler, s_state, max_depth, remat=remat)))
    return torch.mean(torch.stack(vals))


def jax_mean_radiance(scene, cam, film, spp, max_depth, seed=7):
    """tests/test_grad.py's ``_mean_radiance`` with the sample map as a
    Python loop (the same values; it runs op by op)."""
    res = film.resolution[0]
    sampler = JaxIndependent(spp, seed=seed)
    ys, xs = jnp.meshgrid(jnp.arange(res, dtype=jnp.int32), jnp.arange(res, dtype=jnp.int32),
                          indexing="ij")
    pixel_xy = jnp.stack([xs.reshape(-1), ys.reshape(-1)], axis=-1)
    vals = []
    for i in range(spp):
        s_state = sampler.start_pixel_sample(pixel_xy, jnp.uint32(i))
        u_lam, s_state = sampler.get_1d(s_state)
        swl = film.sample_wavelengths(u_lam)
        u_f, s_state = sampler.get_pixel_2d(s_state)
        u_l, s_state = sampler.get_2d(s_state)
        p_film, _, u_l = jax_camera_sample(film.filter, pixel_xy, u_f, u_l)
        ray = cam.generate_ray(p_film, u_l)
        vals.append(jnp.mean(jax_li_path(scene, ray, swl, sampler, s_state, max_depth)))
    return jnp.mean(jnp.stack(vals))


def set_entry(t: torch.Tensor, index, theta, add=False):
    """``t`` with ``t[index]`` set to (or, with ``add``, increased by) the
    0-d tensor ``theta``, differentiably."""
    mask = torch.zeros(t.shape, dtype=torch.bool)
    mask[index] = True
    if add:
        return t + torch.where(mask, theta, torch.zeros((), dtype=t.dtype))
    return torch.where(mask, theta, t)


def replace(obj, table: str, **fields):
    """``obj`` with ``obj.<table>`` replaced by a copy with ``fields``."""
    return dataclasses.replace(obj, **{table: dataclasses.replace(getattr(obj, table), **fields)})


def port_fd_vs_ad(f, theta0: float, h, rtol, atol=0.0):
    """Central finite difference of the port's ``f`` at ``theta0`` (float32
    arithmetic, as the reference's ``_fd_vs_ad``) against its AD."""
    th = torch.tensor(theta0, dtype=torch.float32, requires_grad=True)
    (g_ad,) = torch.autograd.grad(f(th), th)
    g_ad = float(g_ad)
    th0 = torch.tensor(theta0, dtype=torch.float32)
    with torch.no_grad():
        g_fd = float((f(th0 + h) - f(th0 - h)) / (2.0 * h))
    np.testing.assert_allclose(g_ad, g_fd, rtol=rtol, atol=atol, err_msg=f"ad={g_ad} fd={g_fd}")
    return g_ad, g_fd


def ad_vs_reference(f, jf, *theta0: float):
    """The port's value and AD of ``f`` against the reference's
    ``jax.value_and_grad`` of ``jf``, op by op, with respect to each of
    the scalar arguments.  Returns the port's gradients."""
    th = [torch.tensor(t, dtype=torch.float32, requires_grad=True) for t in theta0]
    v = f(*th)
    g = [float(x) for x in torch.autograd.grad(v, th)]
    with jax.disable_jit():
        jv, jg = jax.value_and_grad(jf, argnums=tuple(range(len(th))))(
            *(jnp.float32(t) for t in theta0))
    np.testing.assert_allclose(float(v.detach()), float(jv), rtol=1e-6)
    for gi, jgi in zip(g, jg):
        assert np.isfinite(gi)
        np.testing.assert_allclose(gi, float(jgi), rtol=AD_RTOL,
                                   err_msg=f"port={gi} reference={float(jgi)}")
    return g


# --- tests/test_grad.py::TestGradients' scenes and parameters ---


def _sphere_and_light(albedo, spectrum, scale, render_from_world):
    return jax_build_scene(
        spheres=[{"radius": 1.0, "material_id": 0},
                 {"radius": 0.3, "material_id": 1, "area_light_id": 0,
                  "object_to_world": JaxTransform.translate(jnp.array([0.0, 2.0, 0.0]))}],
        materials=[{"kind": jmtl.DIFFUSE, "reflectance": albedo},
                   {"kind": jmtl.DIFFUSE, "reflectance": [0.0, 0.0, 0.0]}],
        lights=[{"kind": jlt.AREA, "spectrum": JaxConstant(spectrum), "scale": scale,
                 "shape_kind": 0, "shape_idx": 1}],
        render_from_world=render_from_world,
    )


def _in_env(material, render_from_world, textures=None):
    cs = jax_colorspace("srgb")
    return jax_build_scene(
        spheres=[{"radius": 1.0, "material_id": 0}], materials=[material],
        lights=[{"kind": jlt.UNIFORM_INFINITE, "spectrum": cs.illuminant, "photometric": True}],
        textures=textures, render_from_world=render_from_world,
    )


def _textured(render_from_world):
    b = jtx.TextureBuilder()
    tid = b.add_image(np.full((4, 4, 3), 0.5, np.float32), is_spectrum=True,
                      filter_kind=jtx.FILTER_POINT)
    return _in_env({"kind": jmtl.DIFFUSE, "reflectance": [0.5, 0.5, 0.5],
                    "tex_reflectance": tid}, render_from_world, b.build())


# The texel that tests/test_grad.py perturbs (row 1, col 1 of the 4x4
# level-0 image, under the sphere's footprint), and the level's texels.
TEXEL, N_TEXELS = 1 * 4 + 1, 16


@dataclasses.dataclass(frozen=True)
class Case:
    """One parameter of one scene: ``build(render_from_world)`` makes the
    reference scene; ``table`` / ``fields`` / ``index`` name the entry,
    the same in both packages (``index`` may depend on the scene, then it
    is a function of it); ``add`` shifts the entries by theta instead of
    setting them; ``fd`` holds tests/test_grad.py's h / rtol / atol and
    ``nonzero`` its bound on |AD| (``positive``: AD > 0)."""

    build: object
    table: str
    fields: tuple
    index: object
    fd: dict
    nonzero: float = 0.0
    positive: bool = False
    add: bool = False

    def entry(self, jscene):
        return self.index(jscene) if callable(self.index) else self.index

    def theta0(self, jscene) -> float:
        if self.add:
            return 0.0
        return float(np.asarray(getattr(getattr(jscene, self.table), self.fields[0]))[
            self.entry(jscene)])

    def port_f(self, scene, jscene, res, spp, depth):
        cam, film = port_camera(jax_camera(res)), port_film(res)
        idx = self.entry(jscene)

        def f(theta):
            table = getattr(scene, self.table)
            new = {k: set_entry(getattr(table, k), idx, theta, add=self.add) for k in self.fields}
            return port_mean_radiance(replace(scene, self.table, **new), cam, film, spp, depth)

        return f

    def jax_f(self, jscene, res, spp, depth):
        jcam, jfilm = jax_camera(res), jax_film(res)
        idx = self.entry(jscene)

        def f(theta):
            table = getattr(jscene, self.table)
            new = {}
            for k in self.fields:
                at = getattr(table, k).at[idx]
                new[k] = at.add(theta) if self.add else at.set(theta)
            return jax_mean_radiance(
                dataclasses.replace(jscene, **{self.table: dataclasses.replace(table, **new)}),
                jcam, jfilm, spp, depth)

        return f


def _level0(jscene):
    return int(np.asarray(jscene.textures.level0_offset)[0])


CASES = {
    "diffuse_reflectance": Case(
        lambda r2w: _sphere_and_light([0.6, 0.5, 0.4], 20.0, 1.0, r2w), "materials",
        ("reflectance",), (0, 1), dict(h=1e-2, rtol=2e-2), nonzero=1e-6),
    "emission_scale": Case(
        lambda r2w: _sphere_and_light([0.7, 0.7, 0.7], 1.0, 20.0, r2w), "lights",
        ("scale",), (0,), dict(h=0.5, rtol=1e-3), positive=True),
    "conductor_roughness": Case(
        lambda r2w: _in_env({"kind": jmtl.CONDUCTOR, "uroughness": 0.09, "vroughness": 0.09},
                            r2w),
        "materials", ("uroughness", "vroughness"), (0,), dict(h=1e-2, rtol=5e-2, atol=1e-4),
        nonzero=1e-6),
    "texture_texel": Case(
        _textured, "textures", ("atlas",), lambda js: (_level0(js) + TEXEL, 2),
        dict(h=5e-3, rtol=5e-2, atol=1e-7), nonzero=0.0),
    "texture_whole_atlas": Case(
        _textured, "textures", ("atlas",),
        lambda js: (slice(_level0(js), _level0(js) + N_TEXELS), 2),
        dict(h=5e-3, rtol=5e-2), nonzero=1e-6, add=True),
}


def case_scenes(name):
    """(reference scene, port scene) of a case."""
    jscene = CASES[name].build(jax_camera(FD_SIZE[0]).camera_transform.render_from_world())
    return jscene, port_scene(jscene)


def check_sign(case: Case, g: float):
    if case.positive:
        assert g > 0.0
    else:
        assert abs(g) > case.nonzero, "gradient should be nonzero"
