"""The union of spheres and triangles (shimmer_tpu_torch/scene.py) against
the reference's, on the CPU, and a mixed scene rendered by both
wavefronts.

Scene level: a table of spheres and triangles built by both packages'
``build_scene`` from the same dicts (the port's also carried across with
``scene_from_numpy``); ``scene_intersect`` (with and without per-lane
any-hit), ``scene_intersect_predicate`` and the merged trace of the
wavefront, on seeded rays aimed at both shape kinds.  The reference runs
op by op (``jax.disable_jit``: under ``jax.jit`` XLA contracts the
quadratic's and the re-intersection's products into FMAs, and ``t``
moves by up to ~50 ulps).  Criteria: hit mask, ids and occlusion bits
equal; ``t`` bit-equal on the closest-hit lanes; the other fields within
2e-6 absolute.  An exact tie (a unit sphere and a triangle in z = 1 both hit
at t = 4) goes to the sphere, in both packages.

Render level: the mixed scene below (diffuse, dielectric and rough gold
spheres, a sphere area light, triangles with a quad light and an infinite
light) through each package's pbrt loader and wavefront at 24x16, 2 spp,
depth 5, on ``converted`` and ``torch`` tables, with the criteria of
tests/test_torch_wavefront.py; the count of differing pixels is printed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shimmer_tpu import scene as jscene_mod
from shimmer_tpu.loading.parser import parse_str as jax_parse
from shimmer_tpu.loading.scene_builder import SceneBuilder as JaxBuilder
from shimmer_tpu.ops.transform import Transform as JaxTransform
from shimmer_tpu.render import make_wavefront_renderer as jax_wavefront
from shimmer_tpu.render import pixel_blocks as jax_blocks
from shimmer_tpu.scene_builder import build_scene as jax_build_scene
from shimmer_tpu.shapes.triangle import build_triangle_scene as jax_build_tris
from shimmer_tpu_torch import scene as tscene_mod
from shimmer_tpu_torch.convert import scene_from_numpy
from shimmer_tpu_torch.loading.parser import parse_str as torch_parse
from shimmer_tpu_torch.loading.scene_builder import SceneBuilder as TorchBuilder
from shimmer_tpu_torch.ops.transform import Transform as TorchTransform
from shimmer_tpu_torch.render import make_wavefront_renderer as torch_wavefront
from shimmer_tpu_torch.render import pixel_blocks as torch_blocks
from shimmer_tpu_torch.scene_builder import build_scene as torch_build_scene
from shimmer_tpu_torch.shapes.triangle import build_triangle_scene as torch_build_tris
from test_torch_wavefront import assert_images_agree
from torch_parity import ensure_reference_sah, jax_scene_to_numpy, random_mesh

torch.set_num_threads(1)

SEED = 5
N = 384
FIELD_ATOL = 2e-6
RES = (24, 16)
SPP = 2
RENDER_FROM_WORLD = [-0.25, 0.5, 0.0]


def _spheres(transform_cls):
    """The spheres in render space; the first is given in world space and
    composed with RENDER_FROM_WORLD by build_scene."""
    return [
        {"radius": 0.6, "object_to_world": transform_cls.translate([0.25, -0.5, 0.0]),
         "material_id": 1},
        {"radius": 0.4, "object_to_render": transform_cls.translate([1.2, 0.3, -0.5]),
         "material_id": 2, "z_min": -0.2, "z_max": 0.3},
        {"radius": 0.3, "object_to_render": transform_cls.translate([-1.1, -0.4, 0.6]),
         "material_id": 0, "reverse_orientation": True, "area_light_id": 0},
    ]


def _materials():
    return [{"kind": 0, "reflectance": [0.5, 0.4, 0.3]}, {"kind": 0, "reflectance": [0.2, 0.6, 0.2]},
            {"kind": 0, "reflectance": [0.7, 0.7, 0.7]}]


@pytest.fixture(scope="module")
def union_scenes():
    ensure_reference_sah()
    rng = np.random.default_rng(SEED)
    meshes = [{**random_mesh(rng, n_tri=60, spread=2.0), "material_id": 0}]
    jtris = jax_build_tris(meshes)
    ttris = torch_build_tris(meshes, device="cpu")
    jsc = jax_build_scene(spheres=_spheres(JaxTransform), triangles=jtris, materials=_materials(),
                          render_from_world=JaxTransform.translate(RENDER_FROM_WORLD))
    tsc = torch_build_scene(ttris, materials=_materials(), device="cpu",
                            spheres=_spheres(TorchTransform),
                            render_from_world=TorchTransform.translate(RENDER_FROM_WORLD))
    arrays, census = jax_scene_to_numpy(jsc)
    return jsc, {"torch": tsc, "converted": scene_from_numpy(arrays, census, device="cpu")}


def _rays():
    rng = np.random.default_rng(SEED + 1)
    o = (rng.normal(size=(N, 3)) * 4.0).astype(np.float32)
    target = np.concatenate([
        rng.normal(size=(N // 2, 3)) * 0.4,                      # the spheres
        rng.uniform(-2.0, 2.0, size=(N - N // 2, 3)),            # the triangles
    ])
    d = target - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t_max = np.where(rng.random(N) < 0.25, 2.5, np.inf).astype(np.float32)
    return o, d, t_max


def _si_np(si):
    return {f.name: np.asarray(getattr(si, f.name)) for f in dataclasses.fields(si)}


def _assert_si_equal(got: dict, want: dict, closest=None):
    valid = want["valid"]
    closest = valid if closest is None else closest & valid
    for f in ("valid", "material_id", "area_light_id", "med_in", "med_out"):
        np.testing.assert_array_equal(got[f][closest], want[f][closest], err_msg=f)
    np.testing.assert_array_equal(got["valid"], valid)
    np.testing.assert_array_equal(got["t"][closest], want["t"][closest], err_msg="t")
    for f in ("p", "n", "uv", "wo", "dpdu", "dpdv", "ns", "dpdus"):
        scale = max(1.0, float(np.abs(want[f][closest]).max(initial=0.0)))
        np.testing.assert_allclose(got[f][closest], want[f][closest], rtol=0,
                                   atol=FIELD_ATOL * scale, err_msg=f)


@pytest.mark.parametrize("tables", ["converted", "torch"])
def test_union_intersect_and_predicate(union_scenes, tables):
    jsc, tscenes = union_scenes
    tsc = tscenes[tables]
    assert tsc.has_spheres and tsc.has_triangles
    o, d, t_max = _rays()
    want_any = np.arange(N) % 3 == 0
    jx = [jnp.asarray(x) for x in (o, d, t_max)]
    tx = [torch.from_numpy(x) for x in (o, d, t_max)]
    with jax.disable_jit():
        jsi = jscene_mod.scene_intersect(jsc, *jx)
        jany = jscene_mod.scene_intersect(jsc, *jx, want_any=jnp.asarray(want_any))
        jocc = jscene_mod.scene_intersect_predicate(jsc, *jx)
    tsi = tscene_mod.scene_intersect(tsc, *tx)
    tany = tscene_mod.scene_intersect(tsc, *tx, want_any=torch.from_numpy(want_any))
    tocc = tscene_mod.scene_intersect_predicate(tsc, *tx)
    want = _si_np(jsi)
    assert 0.3 < want["valid"].mean() < 0.95
    hits_sphere = want["valid"] & (np.isin(want["material_id"], [1, 2]))
    assert hits_sphere.sum() > 20 and (want["valid"] & ~hits_sphere).sum() > 20
    _assert_si_equal(_si_np(tsi), want)
    # Any-hit lanes: only valid means anything there.
    _assert_si_equal(_si_np(tany), _si_np(jany), closest=~want_any)
    np.testing.assert_array_equal(tany.valid.numpy(), np.asarray(jany.valid))
    np.testing.assert_array_equal(tocc.numpy(), np.asarray(jocc))
    np.testing.assert_array_equal(tocc.numpy(), want["valid"])


@pytest.mark.parametrize("tables", ["converted", "torch"])
def test_merged_trace_with_spheres(union_scenes, tables):
    """The wavefront's merged trace falls back to the union: extension
    lanes get full interactions, shadow lanes their occlusion bit."""
    jsc, tscenes = union_scenes
    o, d, t_max = _rays()
    n_ext = N // 2
    with jax.disable_jit():
        jsi, jocc = jscene_mod.scene_intersect_merged(
            jsc, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max), n_ext)
    tsi, tocc = tscene_mod.scene_intersect_merged(
        tscenes[tables], torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max), n_ext)
    assert tsi.t.shape == (n_ext,)
    _assert_si_equal(_si_np(tsi), _si_np(jsi))
    np.testing.assert_array_equal(tocc.numpy(), np.asarray(jocc))
    assert 0 < tocc.numpy().mean() < 1


def test_exact_tie_goes_to_the_sphere():
    """A unit sphere at the origin and a triangle in z = 1, both hit at
    t = 4 by a ray from (0, 0, 5) along -z: the sphere (merged first)
    wins in both packages."""
    ensure_reference_sah()
    tri = {"p": np.array([[-0.5, -0.5, 1.0], [0.5, -0.5, 1.0], [0.0, 0.5, 1.0]], np.float32),
           "indices": np.array([[0, 1, 2]], np.int32), "material_id": 1}
    mats = [{"kind": 0, "reflectance": [0.5, 0.5, 0.5]}] * 2
    jsc = jax_build_scene(spheres=[{"radius": 1.0, "material_id": 0}],
                          triangles=jax_build_tris([tri]), materials=mats)
    tsc = torch_build_scene(torch_build_tris([tri], device="cpu"), materials=mats,
                            device="cpu", spheres=[{"radius": 1.0, "material_id": 0}])
    o = np.array([[0.0, 0.0, 5.0]], np.float32)
    d = np.array([[0.0, 0.0, -1.0]], np.float32)
    t_max = np.array([np.inf], np.float32)
    # Both hits are exact here, so the reference may run jitted.
    jsi = jax.jit(jscene_mod.scene_intersect)(jsc, jnp.asarray(o), jnp.asarray(d),
                                              jnp.asarray(t_max))
    tx = [torch.from_numpy(x) for x in (o, d, t_max)]
    tsi = tscene_mod.scene_intersect(tsc, *tx)
    # Both shapes alone hit at exactly t = 4.
    assert float(tscene_mod.sphere_intersect(tsc.spheres, *tx).t[0]) == 4.0
    assert float(tscene_mod.triangle_scene_intersect(tsc.triangles, *tx).t[0]) == 4.0
    assert float(tsi.t[0]) == float(jsi.t[0]) == 4.0
    assert int(tsi.material_id[0]) == int(jsi.material_id[0]) == 0


MIXED_SCENE = """
LookAt 0 1.2 -4  0 0.3 0  0 1 0
Camera "perspective" "float fov" [45]
Film "rgb" "integer xresolution" [24] "integer yresolution" [16]
Sampler "zsobol" "integer pixelsamples" [2]
Integrator "path" "integer maxdepth" [5]
WorldBegin
LightSource "infinite" "rgb L" [0.2 0.25 0.3]
Material "diffuse" "rgb reflectance" [0.5 0.45 0.4]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point3 P" [-4 0 -4  4 0 -4  4 0 4  -4 0 4]
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [8 8 8]
  Material "diffuse" "rgb reflectance" [0 0 0]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
      "point3 P" [-0.6 3 -0.6  0.6 3 -0.6  0.6 3 0.6  -0.6 3 0.6]
AttributeEnd
AttributeBegin
  Material "dielectric" "float eta" [1.5]
  Translate -0.9 0.5 0
  Shape "sphere" "float radius" [0.5]
AttributeEnd
AttributeBegin
  Material "conductor" "spectrum eta" "metal-Au-eta" "spectrum k" "metal-Au-k"
      "float roughness" [0.1]
  Translate 0.9 0.45 0.2
  Shape "sphere" "float radius" [0.45]
AttributeEnd
AttributeBegin
  Material "diffuse" "rgb reflectance" [0.2 0.5 0.7]
  Translate 0 0.25 -0.9
  Scale 1 0.8 1
  Shape "sphere" "float radius" [0.25] "float zmin" [-0.2] "float phimax" [300]
AttributeEnd
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [20 18 15]
  Translate 0.2 1.6 -0.3
  Shape "sphere" "float radius" [0.15]
AttributeEnd
"""


@pytest.fixture(scope="module")
def mixed_jobs():
    ensure_reference_sah()
    jb = JaxBuilder()
    jax_parse(MIXED_SCENE, jb)
    jjob = jb.create()
    tb = TorchBuilder()
    torch_parse(MIXED_SCENE, tb)
    tjob = tb.create(device="cpu")
    arrays, census = jax_scene_to_numpy(jjob.scene)
    wave = jax_wavefront(jjob.scene, jjob.camera, jjob.film, jjob.sampler, max_depth=5,
                         with_stats=True)
    blocks, valids = jax_blocks(jjob.film, RES[0] * RES[1])
    state, stats = wave(jjob.film.init_state(), jnp.arange(SPP, dtype=jnp.uint32),
                        blocks[0], valids[0])
    ref = np.asarray(jjob.film.get_image(state))
    return {"ref": (ref, float(stats["rays"])), "torch": tjob,
            "converted": dataclasses.replace(
                tjob, scene=scene_from_numpy(arrays, census, device="cpu"))}


@pytest.mark.parametrize("tables", ["converted", "torch"])
def test_mixed_scene_render_matches_reference(mixed_jobs, tables):
    ref, rays = mixed_jobs["ref"]
    job = mixed_jobs[tables]
    scene = job.scene
    assert scene.has_spheres and scene.has_triangles and len(scene.spheres.radius) == 4
    wave = torch_wavefront(scene, job.camera, job.film, job.sampler, max_depth=5)
    blocks, valids = torch_blocks(job.film, RES[0] * RES[1], device="cpu")
    state, stats = wave(job.film.init_state("cpu"), torch.arange(SPP), blocks[0], valids[0])
    img = job.film.get_image(state).numpy()
    differ = ~np.isclose(img, ref, rtol=1e-3, atol=1e-4).all(axis=-1)
    print(f"{tables}: {int(differ.sum())} of {differ.size} pixels differ; rays "
          f"{float(stats['rays'])} vs {rays}")
    assert_images_agree(img, ref)


SPHERES_ONLY = """
LookAt 0 0.5 -3  0 0 0  0 1 0
Camera "perspective" "float fov" [50]
Film "rgb" "integer xresolution" [12] "integer yresolution" [8]
Sampler "zsobol" "integer pixelsamples" [1]
Integrator "path" "integer maxdepth" [3]
WorldBegin
LightSource "infinite" "rgb L" [0.5 0.5 0.5]
Material "diffuse" "rgb reflectance" [0.6 0.5 0.4]
Shape "sphere" "float radius" [0.7]
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [10 10 10] "bool twosided" true
  Translate 0.8 0.9 -0.4
  Shape "sphere" "float radius" [0.2]
AttributeEnd
"""


def test_sphere_only_scene_renders_as_the_reference():
    """A scene without triangles: the union of spheres alone, sphere area
    lights only, and Scene.device / to() without a triangle table."""
    jb, tb = JaxBuilder(), TorchBuilder()
    jax_parse(SPHERES_ONLY, jb)
    torch_parse(SPHERES_ONLY, tb)
    jjob, job = jb.create(), tb.create(device="cpu")
    scene = job.scene.to("cpu")
    assert scene.triangles is None and not scene.has_triangles and scene.device.type == "cpu"
    res = job.film.resolution
    wave = jax_wavefront(jjob.scene, jjob.camera, jjob.film, jjob.sampler, max_depth=3,
                         with_stats=True)
    blocks, valids = jax_blocks(jjob.film, res[0] * res[1])
    jstate, jstats = wave(jjob.film.init_state(), jnp.arange(1, dtype=jnp.uint32), blocks[0],
                          valids[0])
    twave = torch_wavefront(scene, job.camera, job.film, job.sampler, max_depth=3)
    tblocks, tvalids = torch_blocks(job.film, res[0] * res[1], device="cpu")
    state, stats = twave(job.film.init_state("cpu"), torch.arange(1), tblocks[0], tvalids[0])
    assert float(stats["rays"]) == float(jstats["rays"])
    assert_images_agree(job.film.get_image(state).numpy(), np.asarray(jjob.film.get_image(jstate)))
