"""Homogeneous media of the port against the reference, on the CPU.

Tables: ``make_media_table`` for rgb (the unbounded uplift), scalar and
spectrum sigmas, byte for byte; the loader's media scenes
(``MakeNamedMedium``, ``MediumInterface``, the interface material, the
camera medium) give tables and census equal to the reference loader's.

Functions, the reference op by op (``jax.disable_jit``) on seeded inputs:
``medium_sigma`` bit for bit; ``_medium_segment`` (the free-flight
distance and the throughput) within 1e-6 relative on the lanes whose
scatter decision agrees.  ``-log1p(-u) / sigma`` may differ in the last
ulp between torch and XLA, which can flip ``t_m < t_seg`` on an ulp-close
lane: the test counts the flipped lanes, prints the count (0 of 4,096
when it was written) and allows at most 2.  ``sample_ld_medium_prepare``
within 1e-6 on the lanes that sampled a delta light; on the quad-light
lanes the spherical-triangle sample turns last-ulp differences of its
trigonometry into ~1e-5 of the shadow direction's length, so those lanes
hold the direction and the contribution within 1e-4 relative (3.6e-5
the largest gap when written) and count the lanes beyond 1e-5 (6 of 555
when written, at most 12 allowed); the merged closest-hit trace of
both halves with its interaction fields; ``shadow_march_interfaces`` on a scene of two
interface boxes and an opaque sphere: ``visible`` equal, ``tr`` within
1e-5.
"""

import os

os.environ.setdefault("OMP_NUM_THREADS", "1")

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shimmer_tpu import media as jmedia
from shimmer_tpu import scene as jscene_mod
from shimmer_tpu.color.colorspace import get_named_color_space as jcs
from shimmer_tpu.integrators import path as jpath
from shimmer_tpu.loading.errors import ParameterError as JParameterError
from shimmer_tpu.loading.parser import parse_str as jax_parse
from shimmer_tpu.loading.scene_builder import SceneBuilder as JaxBuilder
from shimmer_tpu.samplers import ZSobolSampler as JZSobol
from shimmer_tpu.spectra.sampled import SampledWavelengths as JSwl
from shimmer_tpu.spectra.spectrum import named_spectrum as jnamed
from shimmer_tpu_torch import media as tmedia
from shimmer_tpu_torch import scene as tscene_mod
from shimmer_tpu_torch.color.colorspace import get_named_color_space as tcs
from shimmer_tpu_torch.convert import scene_from_numpy
from shimmer_tpu_torch.integrators import path as tpath
from shimmer_tpu_torch.loading.errors import ParameterError
from shimmer_tpu_torch.loading.parser import parse_str
from shimmer_tpu_torch.loading.scene_builder import SceneBuilder
from shimmer_tpu_torch.samplers import ZSobolSampler as TZSobol
from shimmer_tpu_torch.spectra.sampled import SampledWavelengths as TSwl
from shimmer_tpu_torch.spectra.spectrum import named_spectrum as tnamed
from test_torch_loader import assert_scene_tables_equal
from torch_parity import ensure_reference_sah, jax_scene_to_numpy

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)
N = 4096
MAX_FLIPS = 2
AREA_RTOL = 1e-4    # quad-light lanes (3.6e-5 the largest gap when written)
AREA_DRIFT = 1e-5   # quad-light lanes whose direction differs by more are counted
MAX_AREA_DRIFTS = 12


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def same_bits(got, want, what=""):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert got.tobytes() == want.tobytes(), what


MEDIA = {
    "rgb": lambda named: [{"sigma_a": (0.4, 0.2, 0.1), "sigma_s": (0.2, 0.5, 0.3), "g": 0.6},
                          {"sigma_a": (0.0, 0.0, 0.0), "sigma_s": (1.5, 1.5, 1.5), "scale": 0.3}],
    "scalar": lambda named: [{"sigma_a": 0.05, "sigma_s": 0.2, "g": -0.3, "scale": 2.0}],
    "spectrum": lambda named: [{"sigma_a": named("glass-BK7"), "sigma_s": 0.1},
                               {"sigma_a": 0.0, "sigma_s": named("metal-Cu-k"), "g": 0.2}],
}


@pytest.mark.parametrize("case", list(MEDIA))
def test_media_table_matches_reference(case):
    want = jmedia.make_media_table(MEDIA[case](jnamed), jcs("srgb"))
    got = tmedia.make_media_table(MEDIA[case](tnamed), tcs("srgb"), device="cpu")
    for f in ("sigma_a", "sigma_s", "g"):
        same_bits(getattr(got, f), getattr(want, f), f)
    assert (got.sigma_a.numpy() >= 0).all() and got.sigma_s.numpy().max() > 0


def _tables():
    media = MEDIA["rgb"](None) + MEDIA["scalar"](None)
    return (jmedia.make_media_table(media, jcs("srgb")),
            tmedia.make_media_table(media, tcs("srgb"), device="cpu"))


def _swl(rng, n):
    lam = rng.uniform(360.0, 830.0, (n, 4)).astype(np.float32)
    pdf = rng.uniform(0.001, 0.004, (n, 4)).astype(np.float32)
    return JSwl(lam=jnp.asarray(lam), pdf=jnp.asarray(pdf)), TSwl(lam=t(lam), pdf=t(pdf))


def test_medium_sigma_matches_reference():
    rng = np.random.default_rng(3)
    jm, tm = _tables()
    mid = rng.integers(-1, 3, N).astype(np.int32)
    jswl, tswl = _swl(rng, N)
    with jax.disable_jit():
        want = jmedia.medium_sigma(jm, jnp.asarray(mid), jswl.lam)
    got = tmedia.medium_sigma(tm, t(mid), tswl.lam)
    for name, a, b in zip(("sigma_a", "sigma_s"), want, got):
        same_bits(b, a, name)
        assert (b.numpy()[mid < 0] == 0).all()
    np.testing.assert_array_equal(got[2].numpy()[mid >= 0], np.asarray(want[2])[mid >= 0])


def _sampler_states(n, seed=0):
    """The same sampler state in both packages: pixel (x, y), sample k."""
    rng = np.random.default_rng(seed)
    px = rng.integers(0, 64, (n, 2)).astype(np.int32)
    samp = np.uint32(rng.integers(0, 16))
    js = JZSobol(16, (64, 64))
    ts = TZSobol(16, (64, 64))
    return (js, js.start_pixel_sample(jnp.asarray(px), jnp.uint32(samp)),
            ts, ts.start_pixel_sample(t(px), int(samp)))


def test_medium_segment_matches_reference():
    """Lanes in vacuum and in both kinds of medium, alive or not, with
    hits near and far and escapes (an escape inside a medium must give
    beta 0, not NaN)."""
    rng = np.random.default_rng(4)
    jm, tm = _tables()
    mid = rng.integers(-1, 3, N).astype(np.int32)
    valid = rng.random(N) < 0.7
    t_hit = np.where(valid, rng.exponential(2.0, N), np.inf).astype(np.float32)
    alive = rng.random(N) < 0.85
    beta = rng.uniform(0.1, 2.0, (N, 4)).astype(np.float32)
    jswl, tswl = _swl(rng, N)
    js, jst, ts, tst = _sampler_states(N)
    jsi = types.SimpleNamespace(valid=jnp.asarray(valid), t=jnp.asarray(t_hit))
    tsi = types.SimpleNamespace(valid=t(valid), t=t(t_hit))
    with jax.disable_jit():
        j_state, j_beta, j_scat, (j_sig, j_g, j_tm) = jpath._medium_segment(
            types.SimpleNamespace(media=jm), js, jswl, jst, jnp.asarray(mid), jsi,
            jnp.asarray(alive), jnp.asarray(beta))
    t_state, t_beta, t_scat, (t_sig, t_g, t_tm) = tpath._medium_segment(
        types.SimpleNamespace(media=tm), ts, tswl, tst, t(mid), tsi, t(alive), t(beta))
    assert int(t_state.dim[0]) == int(j_state.dim[0]) == 1
    j_scat, t_scat = np.asarray(j_scat), t_scat.numpy()
    flips = j_scat != t_scat
    print(f"_medium_segment: {int(flips.sum())} of {N} scatter decisions flipped")
    assert flips.sum() <= MAX_FLIPS
    same = ~flips
    np.testing.assert_array_equal(t_sig.numpy(), np.asarray(j_sig))
    np.testing.assert_allclose(t_tm.numpy(), np.asarray(j_tm), rtol=1e-6, atol=0)
    np.testing.assert_allclose(t_beta.numpy()[same], np.asarray(j_beta)[same], **TOL)
    assert np.isfinite(t_beta.numpy()).all()
    escaped = alive & ~valid & (mid >= 0) & ~t_scat
    assert (t_beta.numpy()[escaped] == 0).all()
    assert t_scat.sum() > 200 and (alive & ~t_scat & (mid >= 0)).sum() > 200


# A floor, two boxes of interface material (smoke and ink inside, fog
# outside), an opaque sphere inside the smoke box, a spot, a point and a
# quad area light; the camera sits in the fog.
_BOX_FACES = [(0, 2, 3, 1), (4, 5, 7, 6), (0, 1, 5, 4), (2, 6, 7, 3), (0, 4, 6, 2), (1, 3, 7, 5)]


def box_text(lo, hi):
    """A 12-triangle box with outward normals as a trianglemesh."""
    lo, hi = np.asarray(lo, float), np.asarray(hi, float)
    p = np.array([[hi[0] if i & 1 else lo[0], hi[1] if i & 2 else lo[1],
                   hi[2] if i & 4 else lo[2]] for i in range(8)])
    idx = []
    for a, b, c, d in _BOX_FACES:
        for tri in ((a, b, c), (a, c, d)):
            n = np.cross(p[tri[1]] - p[tri[0]], p[tri[2]] - p[tri[0]])
            centre = p[list(tri)].mean(0) - (lo + hi) / 2
            idx.extend(tri if n @ centre > 0 else tri[::-1])
    pts = " ".join(f"{x:g}" for x in p.ravel())
    return (f'Shape "trianglemesh" "integer indices" [{" ".join(map(str, idx))}]\n'
            f'    "point3 P" [{pts}]')


TWO_BOXES = f"""
MakeNamedMedium "smoke" "string type" "homogeneous"
    "rgb sigma_a" [0.3 0.2 0.1] "rgb sigma_s" [0.6 0.6 0.6] "float g" [0.6]
MakeNamedMedium "ink" "string type" "homogeneous" "rgb sigma_a" [0.8 0.4 0.2]
    "rgb sigma_s" [0.1 0.1 0.1] "float scale" [2]
MakeNamedMedium "fog" "string type" "homogeneous" "rgb sigma_a" [0.02 0.02 0.02]
    "rgb sigma_s" [0.08 0.08 0.08]
MediumInterface "" "fog"
LookAt 0 1 -5  0 0.3 0  0 1 0
Camera "perspective" "float fov" [45]
Film "rgb" "integer xresolution" [16] "integer yresolution" [12]
Sampler "zsobol" "integer pixelsamples" [2]
Integrator "volpath" "integer maxdepth" [4]
WorldBegin
MediumInterface "" ""
LightSource "point" "point3 from" [0.5 2.5 -1] "rgb I" [3 3 3]
LightSource "spot" "point3 from" [-1 3 -2] "point3 to" [-1 0 0] "blackbody I" [3000]
    "float coneangle" [25] "float conedeltaangle" [5] "float scale" [4]
Material "diffuse" "rgb reflectance" [0.5 0.5 0.5]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point3 P" [-4 0 -4  4 0 -4  4 0 4  -4 0 4]
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [6 6 6]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
      "point3 P" [-0.5 3.5 -0.5  0.5 3.5 -0.5  0.5 3.5 0.5  -0.5 3.5 0.5]
AttributeEnd
AttributeBegin
  Material "diffuse" "rgb reflectance" [0.7 0.3 0.2]
  Translate -1 0.6 0
  Shape "sphere" "float radius" [0.35]
AttributeEnd
AttributeBegin
  MediumInterface "smoke" "fog"
  Material "interface"
  {box_text([-1.8, 0.01, -0.8], [-0.2, 1.6, 0.8])}
AttributeEnd
AttributeBegin
  MediumInterface "ink" "fog"
  Material "interface"
  {box_text([0.4, 0.01, -0.6], [1.6, 1.2, 0.6])}
AttributeEnd
"""


@pytest.fixture(scope="module")
def box_jobs():
    ensure_reference_sah()
    jb, b = JaxBuilder(), SceneBuilder()
    jax_parse(TWO_BOXES, jb)
    parse_str(TWO_BOXES, b)
    return jb.create(), b.create(device="cpu")


def _segments(rng, n, job):
    """Shadow segments from points in and around the boxes toward the
    lights or other points (world space, then to render space), with
    start media by where they start."""
    o = rng.uniform([-2.2, 0.05, -1.2], [2.0, 2.0, 1.2], (n, 3)).astype(np.float32)
    target = np.where(rng.random((n, 1)) < 0.5, np.float32([0.5, 2.5, -1.0]),
                      rng.uniform([-3, -1, -3], [3, 3, 3], (n, 3))).astype(np.float32)
    d = (target - o).astype(np.float32)
    in_smoke = np.all((o > [-1.8, 0.01, -0.8]) & (o < [-0.2, 1.6, 0.8]), -1)
    in_ink = np.all((o > [0.4, 0.01, -0.6]) & (o < [1.6, 1.2, 0.6]), -1)
    order = sorted(["smoke", "ink", "fog"])
    med = np.where(in_smoke, order.index("smoke"), np.where(in_ink, order.index("ink"),
                                                             order.index("fog")))
    live = rng.random(n) < 0.85
    r2w = job.camera.camera_transform.render_from_world()
    o = r2w.apply_point(t(o)).numpy()
    d = r2w.apply_vector(t(d)).numpy()
    return o, d, np.full(n, 1.0 - 1e-3, np.float32), live, med.astype(np.int32)


def test_sample_ld_medium_prepare_matches_reference(box_jobs):
    jjob, job = box_jobs
    rng = np.random.default_rng(5)
    n = 1024
    p_m = rng.uniform([-2, 0.1, -1], [2, 2, 1], (n, 3)).astype(np.float32)
    p_m = job.camera.camera_transform.render_from_world().apply_point(t(p_m)).numpy()
    wo = rng.normal(size=(n, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    g = rng.choice(np.float32([0.0, 0.6, -0.3]), n).astype(np.float32)
    jswl, tswl = _swl(rng, n)
    js, jst, ts, tst = _sampler_states(n, seed=6)
    with jax.disable_jit():
        jc, (jo, jd, jtm, ju), jst2 = jpath.sample_ld_medium_prepare(
            jjob.scene, jnp.asarray(p_m), jnp.asarray(wo), jnp.asarray(g), jswl, js, jst)
    tc, (to, td, ttm, tu), tst2 = tpath.sample_ld_medium_prepare(
        job.scene, t(p_m), t(wo), t(g), tswl, ts, tst)
    assert int(tst2.dim[0]) == int(jst2.dim[0]) == 3
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    # The light each lane sampled: the delta lights are held at TOL, the
    # quad light's lanes at AREA_RTOL, its shadow direction as a vector.
    u, _ = ts.get_1d(tst)
    kind = job.scene.lights.kind[tscene_mod.sample_light(job.scene, u)[0].long()].numpy()
    delta = kind != 3
    assert delta.sum() > 300 and (~delta).sum() > 300
    for name, a, b in (("sh_o", jo, to), ("sh_tmax", jtm, ttm)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL, err_msg=name)
    for name, a, b in (("contrib", jc, tc), ("sh_d", jd, td)):
        np.testing.assert_allclose(b.numpy()[delta], np.asarray(a)[delta], **TOL, err_msg=name)
    np.testing.assert_allclose(tc.numpy()[~delta], np.asarray(jc)[~delta], rtol=AREA_RTOL,
                               atol=0, err_msg="contrib")
    jd_, td_ = np.asarray(jd)[~delta], td.numpy()[~delta]
    gap = np.abs(td_ - jd_).max(-1) / np.linalg.norm(jd_, axis=-1)
    drifts = int((gap > AREA_DRIFT).sum())
    print(f"quad-light lanes beyond {AREA_DRIFT}: {drifts} of {gap.size}, "
          f"largest gap {gap.max():.3g}")
    assert gap.max() <= AREA_RTOL and drifts <= MAX_AREA_DRIFTS
    assert 0.2 < tu.numpy().mean() < 1.0 and (tc.numpy() > 0).any()


def _si_fields(si):
    return {f.name: np.asarray(getattr(si, f.name)) for f in dataclasses.fields(si)
            if getattr(si, f.name) is not None}


def test_merged_full_trace_matches_reference(box_jobs):
    """Both halves of the merged trace get closest-hit interactions: the
    shadow half carries the material, media ids and normal the march
    reads."""
    jjob, job = box_jobs
    rng = np.random.default_rng(7)
    n = 256
    o, d, tmax, live, _ = _segments(rng, n, job)
    ext_d = rng.normal(size=(n, 3)).astype(np.float32)
    ext_d /= np.linalg.norm(ext_d, axis=-1, keepdims=True)
    mo = np.concatenate([o, o])
    md = np.concatenate([ext_d, d]).astype(np.float32)
    mt = np.concatenate([np.where(rng.random(n) < 0.8, np.inf, -np.inf),
                         np.where(live, tmax, -np.inf)]).astype(np.float32)
    with jax.disable_jit():
        jsi = jscene_mod.scene_intersect_merged_full(jjob.scene, jnp.asarray(mo), jnp.asarray(md),
                                                     jnp.asarray(mt), n)
    tsi = tscene_mod.scene_intersect_merged_full(job.scene, t(mo), t(md), t(mt), n)
    for half, (a, b) in enumerate(zip(jsi, tsi)):
        want, got = _si_fields(a), _si_fields(b)
        v = want["valid"]
        assert v.sum() > 50, half
        np.testing.assert_array_equal(got["valid"], v)
        for f in ("material_id", "med_in", "med_out", "area_light_id"):
            np.testing.assert_array_equal(got[f][v], want[f][v], err_msg=f)
        for f in ("t", "p", "n"):
            np.testing.assert_allclose(got[f][v], want[f][v], rtol=0, atol=2e-6, err_msg=f)
    assert (np.asarray(jsi[1].material_id) == -1).any()


def test_shadow_march_matches_reference(box_jobs):
    jjob, job = box_jobs
    rng = np.random.default_rng(8)
    n = 512
    o, d, tmax, live, med = _segments(rng, n, job)
    jswl, tswl = _swl(rng, n)
    with jax.disable_jit():
        jvis, jtr = jpath.shadow_march_interfaces(
            jjob.scene, jswl, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax),
            jnp.asarray(live), jnp.asarray(med))
    tvis, ttr = tpath.shadow_march_interfaces(job.scene, tswl, t(o), t(d), t(tmax), t(live),
                                              t(med))
    np.testing.assert_array_equal(tvis.numpy(), np.asarray(jvis))
    np.testing.assert_allclose(ttr.numpy(), np.asarray(jtr), rtol=1e-5, atol=1e-6)
    vis = tvis.numpy()
    # Visible segments through boxes (tr < 1 beyond the fog alone),
    # occluded ones, and some that cross more than one boundary.
    assert vis.sum() > 50 and (live & ~vis).sum() > 50
    assert (ttr.numpy()[vis, 0] < 0.5).sum() > 10


_MEDIA_BASE = """
%s
LookAt 0 1 -4  0 0 0  0 1 0
Camera "perspective" "float fov" [40]
Film "rgb" "integer xresolution" [8] "integer yresolution" [8]
Sampler "zsobol" "integer pixelsamples" [1]
Integrator "volpath"
WorldBegin
%s
LightSource "point" "point3 from" [0 2 0] "rgb I" [2 2 2]
Material "diffuse" "rgb reflectance" [0.5 0.5 0.5]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point3 P" [-2 0 -2  2 0 -2  2 0 2  -2 0 2]
AttributeBegin
  %s
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
      "point3 P" [-1 0.5 -1  1 0.5 -1  1 0.5 1  -1 0.5 1]
  Shape "sphere" "float radius" [0.3]
AttributeEnd
"""
_FOG = ('MakeNamedMedium "fog" "string type" "homogeneous" "rgb sigma_a" [0.1 0.2 0.3]\n'
        '    "rgb sigma_s" [0.5 0.4 0.3] "float scale" [0.5] "float g" [0.25]\n'
        'MakeNamedMedium "dust" "string type" "homogeneous" "rgb sigma_s" [2 2 2]')
MEDIA_SCENES = {
    "named_medium": (_FOG, "", ""),
    "camera_medium": (_FOG + '\nMediumInterface "" "fog"', 'MediumInterface "" ""', ""),
    "medium_interface": (_FOG, "", 'MediumInterface "dust" "fog"'),
    "interface_material": (_FOG, "", 'MediumInterface "dust" ""\n  Material "interface"'),
    "none_material": (_FOG + '\nMediumInterface "fog" "fog"', "",
                      'MediumInterface "" "dust"\n  Material "none"'),
    "empty_material": (_FOG, "", 'Material ""'),
    "named_interface_material": (_FOG, 'MakeNamedMaterial "gap" "string type" "interface"',
                                 'MediumInterface "dust" "fog"\n  NamedMaterial "gap"'),
    "world_interface": (_FOG + '\nMediumInterface "" "fog"', "", ""),
}


@pytest.mark.parametrize("case", list(MEDIA_SCENES))
def test_loader_media_scene_matches_reference(case):
    """Every media table, light table and triangle table (the medium ids
    in the attribute rows), and the census, equal the reference loader's;
    the scene carried across by scene_from_numpy equals the port's own."""
    ensure_reference_sah()
    text = _MEDIA_BASE % MEDIA_SCENES[case]
    jb, b = JaxBuilder(), SceneBuilder()
    jax_parse(text, jb)
    parse_str(text, b)
    jscene, scene = jb.create().scene, b.create(device="cpu").scene
    assert_scene_tables_equal(scene, jscene)
    arrays, census = jax_scene_to_numpy(jscene)
    for c in ("sigma_a", "sigma_s", "g"):
        same_bits(getattr(scene.media, c), arrays[f"media.{c}"], c)
    conv = scene_from_numpy(arrays, census, device="cpu")
    assert (conv.camera_medium, conv.has_interface_media) == (scene.camera_medium,
                                                               scene.has_interface_media)
    assert conv.triangles.has_iface_media == scene.triangles.has_iface_media
    for c in ("sigma_a", "sigma_s", "g"):
        same_bits(getattr(conv.media, c), arrays[f"media.{c}"], c)
    expect = {"named_medium": (-1, False), "camera_medium": (1, False),
              "medium_interface": (-1, True), "interface_material": (-1, True),
              "none_material": (1, True), "empty_material": (-1, False),
              "named_interface_material": (-1, True), "world_interface": (1, True)}[case]
    assert (scene.camera_medium, scene.has_interface_media) == expect
    mat = scene.triangles.attr_rows[:, 15].numpy()
    assert ((mat == -1).any()) == (case in ("interface_material", "none_material",
                                            "empty_material"))


def test_undefined_medium_name_raises():
    text = _MEDIA_BASE % ("", "", 'MediumInterface "nosuch" ""')
    with pytest.raises(JParameterError):
        jax_parse(text, JaxBuilder())
    with pytest.raises(ParameterError, match="undefined medium"):
        parse_str(text, SceneBuilder())
