"""The port's image environment light and its sampling tables
(shimmer_tpu_torch/lights/env.py, ops/sampling.py's piecewise-constant
distributions, ops/vecmath.py's equal-area maps) against the reference's,
on the CPU, and the textured, env-lit slice as a whole.

- Tables are byte-equal: ``xla_cumsum`` adds in the order the reference's
  cumsum adds on the CPU (blocks of 16, recursively), so the 1-D and 2-D
  CDFs, and the env light's coefficient, scale and distribution tables of
  a square and of a lat-long map, are the reference's to the bit.
- With equal CDFs, a sample lands in the same bin: the 2-D sample (a
  binary search per lane in the port, a whole-row comparison in the
  reference) and both pdfs are bit-equal.  The equal-area maps and the
  env's lookups agree within rtol 1e-6 / atol 1e-6 (``TOL``): they take
  cos, sin, atan and rsqrt, which the two CPU libraries may round an ulp
  apart (the 3x3 rotations add in the reference's fused order); the shadow
  target p_light, which scales wi by the scene's diameter (24 here), within
  atol 24e-6.
- tests/test_textures.py's env checks run on the port: the sample / pdf
  consistency, and NEE with MIS against BSDF-only sampling (ZSobol for the
  path, an independent numpy stream for the BSDF-only estimate written
  here, since the port has no other estimator).

The slice as a whole, a textured and env-lit render against the
reference's, is tests/test_torch_textured_render.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shimmer_tpu.color.colorspace import get_named_color_space as jcs
from shimmer_tpu.lights import env as jenv
from shimmer_tpu.lights import lights as jlt
from shimmer_tpu.ops import math as jmath
from shimmer_tpu.ops import sampling as jsmp
from shimmer_tpu.ops import vecmath as jvm
from shimmer_tpu.ops.transform import Transform as JTransform
from shimmer_tpu.spectra.sampled import SampledWavelengths as JSwl
from shimmer_tpu_torch.color.colorspace import get_named_color_space as tcs
from shimmer_tpu_torch.lights import env as tenv
from shimmer_tpu_torch.lights import lights as tlt
from shimmer_tpu_torch.ops import math as tmath
from shimmer_tpu_torch.ops import sampling as tsmp
from shimmer_tpu_torch.ops import vecmath as tvm
from shimmer_tpu_torch.ops.transform import Transform as TTransform
from shimmer_tpu_torch.spectra.sampled import SampledWavelengths as TSwl

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)


def t(x):
    return torch.from_numpy(np.array(x))


def same_bits(a, b, what=""):
    a, b = np.asarray(a), b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


# --- cumsum, find_interval, distributions ---


@pytest.mark.parametrize("shape", [(1,), (16,), (17,), (300,), (1025,), (5, 257), (3, 4097)])
def test_xla_cumsum_bit_equal(shape):
    x = np.random.default_rng(1).uniform(0, 10, shape).astype(np.float32)
    same_bits(jnp.cumsum(jnp.asarray(x), axis=-1), tsmp.xla_cumsum(t(x)), str(shape))


def test_find_interval_matches_reference():
    rng = np.random.default_rng(2)
    xs = np.sort(rng.uniform(0, 1, 33)).astype(np.float32)
    x = np.concatenate([rng.uniform(-0.2, 1.2, 500), xs]).astype(np.float32)
    np.testing.assert_array_equal(tmath.find_interval(t(xs), t(x)).numpy(),
                                  np.asarray(jmath.find_interval(jnp.asarray(xs), jnp.asarray(x))))


def _funcs_2d(rng):
    f = rng.uniform(0, 2, (24, 40)).astype(np.float32)
    f[3] = 0.0  # a zero row becomes uniform
    f[:, 7] = 0.0
    return {"random": f, "zero": np.zeros((8, 8), np.float32), "spike": np.pad(
        np.ones((1, 1), np.float32), ((5, 10), (30, 2)))}


@pytest.mark.parametrize("case", ["random", "zero", "spike"])
def test_piecewise_constant_2d_matches_reference(case):
    rng = np.random.default_rng(3)
    f = _funcs_2d(rng)[case]
    jd = jsmp.build_piecewise_constant_2d(f)
    td = tsmp.build_piecewise_constant_2d(f, device="cpu")
    for field in ("func", "cond_cdf", "cond_int", "marg_cdf", "marg_func", "marg_int"):
        same_bits(getattr(jd, field), getattr(td, field), field)
    u = rng.uniform(0, 1, (2000, 2)).astype(np.float32)
    u[:40] = np.asarray(jd.cond_cdf)[rng.integers(0, f.shape[0], 40), rng.integers(0, f.shape[1], 40)][:, None]
    (jp, jpdf), (tp, tpdf) = jd.sample(jnp.asarray(u)), td.sample(t(u))
    same_bits(jp, tp, "point")
    same_bits(jpdf, tpdf, "pdf")
    same_bits(jd.pdf_at(jnp.asarray(u)), td.pdf_at(t(u)), "pdf_at")


def test_piecewise_constant_1d_matches_reference():
    rng = np.random.default_rng(4)
    f = rng.uniform(0, 3, 50).astype(np.float32)
    fb = rng.uniform(0, 3, (30, 12)).astype(np.float32)
    fb[2] = 0.0
    u = rng.uniform(0, 1, 30).astype(np.float32)
    for func, uu, dom in ((f, rng.uniform(0, 1, 500).astype(np.float32), (-1.0, 3.0)),
                          (fb, u, (0.0, 1.0))):
        jd = jsmp.build_piecewise_constant_1d(func, *dom)
        td = tsmp.build_piecewise_constant_1d(func, *dom, device="cpu")
        for field in ("func", "cdf", "func_int"):
            same_bits(getattr(jd, field), getattr(td, field), field)
        jx, jpdf, jo = jd.sample(jnp.asarray(uu))
        tx, tpdf, to = td.sample(t(uu))
        same_bits(jx, tx, "x")
        same_bits(jpdf, tpdf, "pdf")
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        same_bits(jd.pdf_at(jx), td.pdf_at(tx), "pdf_at")


# --- equal-area maps ---


def test_equal_area_maps_match_reference():
    rng = np.random.default_rng(5)
    p = rng.uniform(0, 1, (4000, 2)).astype(np.float32)
    p[:8] = [[0, 0], [1, 1], [0.5, 0.5], [0, 1], [1, 0], [0.5, 0], [0.25, 0.75], [0.5, 1]]
    a = np.asarray(jvm.equal_area_square_to_sphere(jnp.asarray(p)))
    b = tvm.equal_area_square_to_sphere(t(p)).numpy()
    np.testing.assert_allclose(b, a, **TOL)
    d = rng.normal(size=(4000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:6] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, -1, 0], [0.6, 0.8, 0], [0, 0.6, -0.8]]
    a = np.asarray(jvm.equal_area_sphere_to_square(jnp.asarray(d)))
    b = tvm.equal_area_sphere_to_square(t(d)).numpy()
    np.testing.assert_allclose(b, a, **TOL)
    q = rng.uniform(-1, 2, (500, 2)).astype(np.float32)
    same_bits(jvm.wrap_equal_area_square(jnp.asarray(q)), tvm.wrap_equal_area_square(t(q)))


# --- the env light ---


def _rotation():
    m = np.eye(4)
    c, s = math.cos(0.7), math.sin(0.7)
    m[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    m[:3, 3] = [0.3, -0.2, 0.1]
    return m


def _envs(img):
    m = _rotation()
    jrfl = JTransform(m=jnp.asarray(m, jnp.float32), m_inv=jnp.asarray(np.linalg.inv(m), jnp.float32))
    je = jenv.build_env_light(img, jcs("srgb"), scale=1.7, render_from_light=jrfl, scene_radius=12.0)
    te = tenv.build_env_light(img, tcs("srgb"), scale=1.7,
                              render_from_light=TTransform.from_matrix(m), scene_radius=12.0,
                              device="cpu")
    return je, te


def _sky(shape, seed=6):
    rng = np.random.default_rng(seed)
    img = np.repeat(np.repeat(rng.uniform(0.02, 0.5, (shape[0] // 4, shape[1] // 4, 3)), 4, 0), 4, 1)
    img[2:5, 3:7] = [6.0, 5.0, 3.0]
    return img.astype(np.float32)


@pytest.mark.parametrize("shape", [(16, 16), (16, 32)], ids=["square", "latlong"])
def test_env_tables_byte_equal(shape):
    je, te = _envs(_sky(shape))
    for f in ("coeffs", "texel_scale", "illum_dense", "scale", "render_from_light",
              "light_from_render", "scene_radius"):
        same_bits(getattr(je, f), getattr(te, f), f)
    for f in ("func", "cond_cdf", "cond_int", "marg_cdf", "marg_func", "marg_int"):
        same_bits(getattr(je.distribution, f), getattr(te.distribution, f), f"distribution.{f}")
    assert te.coeffs.shape == ((64, 64, 3) if shape[0] != shape[1] else (16, 16, 3))


def _swl(rng, n):
    lam = rng.uniform(360, 830, (n, 4)).astype(np.float32)
    pdf = np.ones_like(lam)
    return JSwl(lam=jnp.asarray(lam), pdf=jnp.asarray(pdf)), TSwl(lam=t(lam), pdf=t(pdf))


def test_env_lookups_match_reference():
    rng = np.random.default_rng(7)
    je, te = _envs(_sky((16, 32)))
    n = 1024
    d = rng.normal(size=(n, 3)).astype(np.float32)
    jswl, tswl = _swl(rng, n)
    np.testing.assert_allclose(tenv.env_le(te, t(d), tswl).numpy(),
                               np.asarray(jenv.env_le(je, jnp.asarray(d), jswl)), **TOL)
    np.testing.assert_allclose(tenv.env_pdf_li(te, t(d)).numpy(),
                               np.asarray(jenv.env_pdf_li(je, jnp.asarray(d))), **TOL)
    u = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    p = rng.normal(size=(n, 3)).astype(np.float32)
    a = jenv.env_sample_li(je, jnp.asarray(p), jnp.asarray(u), jswl)
    b = tenv.env_sample_li(te, t(p), t(u), tswl)
    for name, x, y in zip(("l", "wi", "pdf", "p_light"), a, b):
        # p_light is wi times the scene's diameter (24): atol scaled so.
        tol = dict(TOL, atol=24e-6) if name == "p_light" else TOL
        np.testing.assert_allclose(y.numpy(), np.asarray(x), **tol, err_msg=name)


def test_image_light_in_the_light_table_matches_reference():
    """lights.sample_li / pdf_li with an image infinite light beside a
    uniform one (light 1 is the image light)."""
    rng = np.random.default_rng(8)
    je, te = _envs(_sky((16, 16)))
    n = 256
    spec = np.ones((2, 471), np.float32)
    j_lights = jlt.LightData(
        kind=jnp.asarray([4, 5], jnp.int32), spectrum=jnp.asarray(spec), scale=jnp.ones(2),
        position=jnp.zeros((2, 3)), direction=jnp.zeros((2, 3)), cos_falloff_start=jnp.ones(2),
        cos_falloff_end=jnp.ones(2), shape_idx=jnp.full(2, -1, jnp.int32),
        shape_kind=jnp.zeros(2, jnp.int32), two_sided=jnp.zeros(2, bool),
        scene_radius=jnp.float32(12.0))
    t_lights = tlt.LightData(
        kind=t(np.int32([4, 5])), spectrum=t(spec), scale=torch.ones(2),
        position=torch.zeros((2, 3)), direction=torch.zeros((2, 3)),
        cos_falloff_start=torch.ones(2), cos_falloff_end=torch.ones(2), shape_idx=t(np.int32([-1, -1])), shape_kind=t(np.int32([0, 0])),
        two_sided=torch.zeros(2, dtype=torch.bool), scene_radius=torch.tensor(12.0))
    idx = (np.arange(n) % 2).astype(np.int32)
    p = rng.normal(size=(n, 3)).astype(np.float32)
    u = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    jswl, tswl = _swl(rng, n)
    a = jlt.sample_li(j_lights, jnp.asarray(idx), jnp.asarray(p), jnp.asarray(p), jnp.asarray(u),
                      jswl, None, (4, 5), env=je)
    b = tlt.sample_li(t_lights, t(idx), t(p), t(p), t(u), tswl, None, (4, 5), env=te)
    for f in ("l", "wi", "pdf", "p_light", "n_light", "valid", "is_delta"):
        tol = dict(TOL, atol=24e-6) if f == "p_light" else TOL
        np.testing.assert_allclose(getattr(b, f).numpy(), np.asarray(getattr(a, f)), **tol,
                                   err_msg=f)
    wi = np.asarray(a.wi)
    np.testing.assert_allclose(
        tlt.pdf_li(t_lights, t(idx), t(p), t(p), t(wi), t(p), t(p), None, (4, 5), env=te).numpy(),
        np.asarray(jlt.pdf_li(j_lights, jnp.asarray(idx), jnp.asarray(p), jnp.asarray(p),
                              jnp.asarray(wi), jnp.asarray(p), jnp.asarray(p), None, (4, 5),
                              env=je)), **TOL)


def test_env_sample_pdf_consistency():
    """tests/test_textures.py::TestEnvLight::test_env_sample_pdf_consistency
    on the port."""
    rng = np.random.default_rng(0)
    img = rng.uniform(0.1, 2.0, (32, 32, 3)).astype(np.float32)
    env = tenv.build_env_light(img, tcs("srgb"), scene_radius=10.0, device="cpu")
    n = 2048
    u = t(rng.uniform(0, 1, (n, 2)).astype(np.float32))
    swl = TSwl.sample_visible(torch.full((n,), 0.3))
    l, wi, pdf, p_light = tenv.env_sample_li(env, torch.zeros((n, 3)), u, swl)
    pdf, pdf2 = pdf.numpy(), tenv.env_pdf_li(env, wi).numpy()
    m = pdf > 0
    np.testing.assert_allclose(pdf[m], pdf2[m], rtol=2e-2)
    est = (1.0 / pdf[m]).mean() / (4.0 * np.pi)
    assert abs(est - 1.0) < 0.05, est


def test_env_nee_vs_bsdf_only_consistency():
    """tests/test_textures.py::TestEnvMIS on the port: the path integrator
    (NEE + MIS against the env's importance map, ZSobol) and a BSDF-only
    estimate agree in the mean.  A lone convex sphere: every bounce
    escapes, so the BSDF-only estimate is one cosine-sampled bounce."""
    from shimmer_tpu_torch.cameras import CameraTransform, PerspectiveCamera
    from shimmer_tpu_torch.film.film import FilmState, PixelSensor, RgbFilm
    from shimmer_tpu_torch.film.filters import BoxFilter
    from shimmer_tpu_torch.materials import material as mtl
    from shimmer_tpu_torch.render import render
    from shimmer_tpu_torch.samplers import ZSobolSampler
    from shimmer_tpu_torch.scene import scene_intersect
    from shimmer_tpu_torch.scene_builder import build_scene
    from shimmer_tpu_torch.spectra.spectrum import ConstantSpectrum

    cs = tcs("srgb")
    rng = np.random.default_rng(5)
    env_img = rng.uniform(0.02, 0.3, (32, 32, 3)).astype(np.float32)
    env_img[4:10, 4:10] = 8.0
    res, spp = (16, 16), 64
    ct = CameraTransform(TTransform.look_at([0.0, 0.0, -4.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]))
    cam = PerspectiveCamera(ct, res, fov=45.0)
    film = RgbFilm(res, BoxFilter(), PixelSensor(cs), cs)
    env = tenv.build_env_light(env_img, cs, scene_radius=50.0, device="cpu")
    scene = build_scene(None, materials=[{"kind": mtl.DIFFUSE, "reflectance": [0.8, 0.8, 0.8]}],
                        lights=[{"kind": tlt.IMAGE_INFINITE, "spectrum": ConstantSpectrum(1.0)}],
                        device="cpu", spheres=[{"radius": 1.0, "material_id": 0}],
                        render_from_world=ct.render_from_world(), env=env)
    img_mis, _ = render(scene, cam, film, ZSobolSampler(spp, res, seed=1), spp=spp, max_depth=2,
                        wave_spp=spp)

    # BSDF-only: camera ray, then one cosine-sampled bounce into the env.
    n = res[0] * res[1] * spp
    pix = np.stack(np.meshgrid(np.arange(res[0]), np.arange(res[1]), indexing="xy"), -1)
    pix = np.repeat(pix.reshape(-1, 2), spp, 0)
    p_film = t((pix + rng.uniform(0, 1, (n, 2))).astype(np.float32))
    swl = film.sample_wavelengths(t(rng.uniform(0, 1, n).astype(np.float32)))
    ray = cam.generate_ray(p_film, torch.zeros((n, 2)))
    si = scene_intersect(scene, ray.o, ray.d, torch.full((n,), float("inf")))
    bs = mtl.bsdf_sample(scene.materials, scene.material_kinds, si.material_id,
                         si.shading_frame(), si.ns, si.wo,
                         t(rng.uniform(0, 1, (n, 2)).astype(np.float32)),
                         t(rng.uniform(0, 1, n).astype(np.float32)), swl)
    beta = bs.f * (torch.abs(tvm.dot(bs.wi, si.ns)) / torch.clamp(bs.pdf, min=1e-20))[..., None]
    l_hit = torch.where(bs.valid[..., None], beta * tenv.env_le(env, bs.wi, swl), 0.0)
    l = torch.where(si.valid[..., None], l_hit, tenv.env_le(env, ray.d, swl))
    rgb = film._clamped_rgb(l, swl).reshape(res[1], res[0], spp, 3).sum(2)
    state = FilmState(rgb_sum=rgb, weight_sum=torch.full((res[1], res[0]), float(spp)),
                      rgb_splat=torch.zeros_like(rgb))
    img_bsdf = film.get_image(state).numpy()
    a = img_mis.numpy()
    assert np.isfinite(a).all() and np.isfinite(img_bsdf).all()
    np.testing.assert_allclose(a.mean(), img_bsdf.mean(), rtol=0.08)
