"""Point, spot and distant lights of the port against the reference, on the
CPU.

``smooth_step`` and ``lights.sample_li`` run on seeded inputs, the
reference op by op (``jax.disable_jit``); the spot light's reference points
straddle both edges of its falloff cone.  Criteria: ``l``, ``wi``,
``pdf``, ``p_light`` and ``n_light`` within 1e-6 relative (1e-6 absolute
below that), ``valid`` and ``is_delta`` equal, and ``pdf_li`` 0 for the
delta kinds.  The light table that ``build_scene`` bakes (positions and
directions through the render-from-world transform, cone cosines, scales,
the power sampler's weights) and the tables of the loader's point, spot
and distant scenes equal the reference's byte for byte.
"""

import os

os.environ.setdefault("OMP_NUM_THREADS", "1")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shimmer_tpu.color.colorspace import get_named_color_space as jcs
from shimmer_tpu.lights import lights as jlt
from shimmer_tpu.loading.parser import parse_str as jax_parse
from shimmer_tpu.loading.scene_builder import SceneBuilder as JaxBuilder
from shimmer_tpu.ops import math as jmath
from shimmer_tpu.ops.transform import Transform as JTransform
from shimmer_tpu.scene_builder import build_scene as jax_build_scene
from shimmer_tpu.spectra.sampled import SampledWavelengths as JSwl
from shimmer_tpu.spectra.spectrum import BlackbodySpectrum as JBlackbody
from shimmer_tpu.spectra.spectrum import ConstantSpectrum as JConstant
from shimmer_tpu_torch.color.colorspace import get_named_color_space as tcs
from shimmer_tpu_torch.lights import lights as tlt
from shimmer_tpu_torch.loading.parser import parse_str
from shimmer_tpu_torch.loading.scene_builder import SceneBuilder
from shimmer_tpu_torch.ops import math as tmath
from shimmer_tpu_torch.ops.transform import Transform as TTransform
from shimmer_tpu_torch.scene_builder import build_scene as torch_build_scene
from shimmer_tpu_torch.spectra.sampled import SampledWavelengths as TSwl
from shimmer_tpu_torch.spectra.spectrum import BlackbodySpectrum as TBlackbody
from shimmer_tpu_torch.spectra.spectrum import ConstantSpectrum as TConstant
from test_torch_loader import assert_scene_tables_equal
from torch_parity import ensure_reference_sah, jax_scene_to_numpy

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)
N = 512
RENDER_FROM_WORLD = [0.3, -0.2, 0.5]


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_smooth_step_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.uniform(-0.5, 1.5, 4096).astype(np.float32)
    a = rng.uniform(-0.2, 0.4, 4096).astype(np.float32)
    b = (a + rng.uniform(0.0, 1.0, 4096)).astype(np.float32)
    b[:64] = a[:64]  # an empty interval: safe_div gives 0, the step 0
    with jax.disable_jit():
        want = np.asarray(jmath.smooth_step(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b)))
    got = tmath.smooth_step(t(x), t(a), t(b)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want == 0).any() and (want == 1).any() and ((want > 0) & (want < 1)).any()


def _light_dicts(pkg):
    """A point, a spot (a 3000 K blackbody aimed down -y, cone 25 with 5 of
    falloff) and a distant light, in world space."""
    constant, blackbody = {"jax": (JConstant, JBlackbody), "torch": (TConstant, TBlackbody)}[pkg]
    return [
        {"kind": tlt.POINT, "spectrum": constant(4.0), "scale": 1.5, "position": (0.5, 2.0, -1.0)},
        {"kind": tlt.SPOT, "spectrum": blackbody(3000.0), "scale": 2.0, "photometric": True,
         "position": (0.0, 3.0, 0.0), "direction": (0.1, -1.0, 0.05), "cone_angle": 25.0,
         "cone_delta": 5.0},
        {"kind": tlt.DISTANT, "spectrum": constant(1.2), "direction": (0.3, -1.0, 0.2)},
    ]


def _scenes(light_sampler="uniform"):
    jsc = jax_build_scene(lights=_light_dicts("jax"), colorspace=jcs("srgb"),
                          light_sampler=light_sampler,
                          render_from_world=JTransform.translate(jnp.asarray(RENDER_FROM_WORLD)))
    tsc = torch_build_scene(None, lights=_light_dicts("torch"), colorspace=tcs("srgb"),
                            light_sampler=light_sampler, device="cpu",
                            render_from_world=TTransform.translate(RENDER_FROM_WORLD))
    return jsc, tsc


def _ref_points(kind, rng):
    """Reference points: around the scene for the point and distant
    lights; for the spot, on rays from the light at 15-35 degrees off its
    axis, so both cone edges (20 and 25 degrees) lie inside the spread."""
    if kind != tlt.SPOT:
        return rng.normal(size=(N, 3)).astype(np.float32) * 2.0
    _, tsc = _scenes()
    pos = tsc.lights.position[1].numpy().astype(np.float64)
    axis = tsc.lights.direction[1].numpy().astype(np.float64)
    u = np.cross(axis, [0.0, 0.0, 1.0])
    u /= np.linalg.norm(u)
    v = np.cross(axis, u)
    theta = np.deg2rad(rng.uniform(15.0, 35.0, N))
    phi = rng.uniform(0.0, 2 * np.pi, N)
    w = (np.cos(theta)[:, None] * axis + np.sin(theta)[:, None]
         * (np.cos(phi)[:, None] * u + np.sin(phi)[:, None] * v))
    return (pos + w * rng.uniform(1.0, 4.0, (N, 1))).astype(np.float32)


@pytest.mark.parametrize("kind", [tlt.POINT, tlt.SPOT, tlt.DISTANT],
                         ids=["point", "spot", "distant"])
def test_sample_li_matches_reference(kind):
    rng = np.random.default_rng(10 + kind)
    jsc, tsc = _scenes()
    assert jsc.light_kinds == tsc.light_kinds == (0, 1, 2)
    idx = np.full(N, [tlt.POINT, tlt.SPOT, tlt.DISTANT].index(kind), np.int32)
    p = _ref_points(kind, rng)
    ns = rng.normal(size=(N, 3)).astype(np.float32)
    u = rng.uniform(0, 1, (N, 2)).astype(np.float32)
    lam = rng.uniform(380.0, 780.0, (N, 4)).astype(np.float32)
    pdf = np.full((N, 4), 1.0 / 400.0, np.float32)
    with jax.disable_jit():
        a = jlt.sample_li(jsc.lights, jnp.asarray(idx), jnp.asarray(p), jnp.asarray(ns),
                          jnp.asarray(u), JSwl(lam=jnp.asarray(lam), pdf=jnp.asarray(pdf)), None,
                          jsc.light_kinds)
        a_pdf = jlt.pdf_li(jsc.lights, jnp.asarray(idx), jnp.asarray(p), jnp.asarray(ns),
                           a.wi, a.p_light, a.n_light, None, jsc.light_kinds)
    b = tlt.sample_li(tsc.lights, t(idx), t(p), t(ns), t(u), TSwl(lam=t(lam), pdf=t(pdf)), None,
                      tsc.light_kinds)
    for f in ("l", "wi", "pdf", "p_light", "n_light"):
        np.testing.assert_allclose(getattr(b, f).numpy(), np.asarray(getattr(a, f)), **TOL,
                                   err_msg=f)
    for f in ("valid", "is_delta"):
        np.testing.assert_array_equal(getattr(b, f).numpy(), np.asarray(getattr(a, f)), err_msg=f)
    assert b.is_delta.all() and (b.pdf == 1.0).all()
    b_pdf = tlt.pdf_li(tsc.lights, t(idx), t(p), t(ns), b.wi, b.p_light, b.n_light, None,
                       tsc.light_kinds)
    assert (b_pdf == 0).all() and (np.asarray(a_pdf) == 0).all()
    if kind == tlt.SPOT:
        # Both sides of the cone and its falloff band are met.
        scale = b.l.numpy()[:, 0] * np.sum((p - tsc.lights.position[1].numpy()) ** 2, -1)
        lit = b.valid.numpy()
        assert (~lit).sum() > 50 and lit.sum() > 50
        full = scale[lit].max()
        assert ((scale[lit] > 0.01 * full) & (scale[lit] < 0.99 * full)).sum() > 20


@pytest.mark.parametrize("light_sampler", ["uniform", "power"])
def test_light_table_matches_reference(light_sampler):
    """Positions and directions go to render space in float32, the cone
    cosines in float64; distant lights weigh lum 4 pi r^2 and point and
    spot lights lum 4 pi under the power sampler."""
    jsc, tsc = _scenes(light_sampler)
    for f in ("kind", "spectrum", "scale", "position", "direction", "cos_falloff_start",
              "cos_falloff_end", "shape_idx", "shape_kind", "two_sided", "scene_radius"):
        want = np.asarray(getattr(jsc.lights, f))
        got = getattr(tsc.lights, f).numpy()
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), f
    want = np.asarray(jsc.light_sample_weights)
    assert tsc.light_sample_weights.numpy().tobytes() == want.tobytes()
    if light_sampler == "power":
        assert len(set(want.tolist())) == 3
    np.testing.assert_allclose(tsc.lights.position[0].numpy(),
                               np.add([0.5, 2.0, -1.0], RENDER_FROM_WORLD), rtol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(tsc.lights.direction.numpy(), axis=-1), 1.0,
                               rtol=1e-6)


_LIGHT_BASE = """
LookAt 0 1 -4  0 0 0  0 1 0
Camera "perspective" "float fov" [40]
Film "rgb" "integer xresolution" [8] "integer yresolution" [8]
Sampler "zsobol" "integer pixelsamples" [1]
Integrator "path" "string lightsampler" "power"
WorldBegin
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point3 P" [-2 0 -2  2 0 -2  2 0 2  -2 0 2]
AttributeBegin
  Translate 0.2 0.5 -0.1
  Rotate 30 0 1 0
  %s
AttributeEnd
"""
LIGHT_SCENES = {
    "point": 'LightSource "point" "point3 from" [0 2 0] "rgb I" [2 1.5 1] "float scale" [3]',
    "spot": ('LightSource "spot" "point3 from" [1 3 -1] "point3 to" [0 0 0.2] '
             '"blackbody I" [3000] "float coneangle" [25] "float conedeltaangle" [5]'),
    "distant": ('LightSource "distant" "point3 from" [0 1 0] "point3 to" [0.3 0 0.2] '
                '"spectrum L" "stdillum-D65" "float scale" [0.5]'),
}


@pytest.mark.parametrize("case", list(LIGHT_SCENES))
def test_loader_delta_light_scene_matches_reference(case):
    """``from`` / ``to`` through the light's CTM in float64, I or L with
    the color space's illuminant, scale and photometric normalization, the
    cone angles."""
    ensure_reference_sah()
    text = _LIGHT_BASE % LIGHT_SCENES[case]
    jb, b = JaxBuilder(), SceneBuilder()
    jax_parse(text, jb)
    parse_str(text, b)
    jscene, scene = jb.create().scene, b.create(device="cpu").scene
    kind = {"point": tlt.POINT, "spot": tlt.SPOT, "distant": tlt.DISTANT}[case]
    assert scene.light_kinds == (kind,)
    assert_scene_tables_equal(scene, jscene)
    arrays, _ = jax_scene_to_numpy(jscene)
    for c in ("position", "direction", "cos_falloff_start", "cos_falloff_end", "scale"):
        assert getattr(scene.lights, c).numpy().tobytes() == arrays[f"lights.{c}"].tobytes(), c
    assert scene.light_sample_weights.numpy().tobytes() == arrays["light_sample_weights"].tobytes()
