"""Scene tables of the port against the reference, on the bench geometry
at 1,280 triangles plus the floor and light quads: the BVH tables are
bit-equal (both packages run the same numpy / native builder), material
and light tables agree to rtol 1e-6, and scene_from_numpy carries a
reference Scene across unchanged."""

import numpy as np
import pytest
import torch

import bench
from shimmer_tpu.color.colorspace import get_named_color_space as jax_cs
from shimmer_tpu.lights import lights as jlt
from shimmer_tpu.scene_builder import build_scene as jax_build_scene
from shimmer_tpu_torch import bench_scene
from shimmer_tpu_torch.color.colorspace import get_named_color_space as torch_cs
from shimmer_tpu_torch.convert import scene_from_numpy
from shimmer_tpu_torch.lights import lights as tlt
from shimmer_tpu_torch.materials import material as tmtl
from shimmer_tpu_torch.ops.traverse import TraverseConfig
from shimmer_tpu_torch.scene_builder import build_scene as torch_build_scene
from shimmer_tpu_torch.shapes.triangle import build_triangle_scene
from shimmer_tpu_torch.spectra.spectrum import ConstantSpectrum
import shimmer_tpu.native as reference_native
from torch_parity import ensure_reference_sah, jax_scene_to_numpy

torch.set_num_threads(1)

N_TRIS = 1280
TABLE_RTOL = 1e-6

BIT_EQUAL_FIELDS = [
    "rows8", "meta", "attr_rows", "light_rows", "indices", "orig_indices",
    "orig_rev", "world_min", "world_max",
]


@pytest.fixture(scope="module")
def jax_scene():
    ensure_reference_sah()
    scene, _, _, _ = bench.build_bench_scene(N_TRIS)
    return scene


@pytest.fixture(scope="module")
def torch_scene():
    scene, _, _ = bench_scene.build_bench_scene(N_TRIS, (24, 16), device="cpu")
    return scene


def test_displaced_sphere_generator_matches_bench():
    for n in (20, 1280):
        vj, fj = bench.make_displaced_sphere(n)
        vt, ft = bench_scene.make_displaced_sphere(n)
        np.testing.assert_array_equal(vt, vj)
        np.testing.assert_array_equal(ft, fj)


@pytest.mark.parametrize("field", BIT_EQUAL_FIELDS)
def test_triangle_tables_bit_equal(jax_scene, torch_scene, field):
    a = np.asarray(getattr(jax_scene.triangles, field))
    b = getattr(torch_scene.triangles, field).numpy()
    assert b.dtype == a.dtype
    np.testing.assert_array_equal(b, a)


def test_reference_sah_failure_cache_is_repaired(torch_scene):
    """A failure the reference's SAH loader cached (as when a worker loads
    a _sah.so that another is still writing) makes the reference build with
    LBVH; ensure_reference_sah clears it, and the tables are bit-equal
    again."""
    with reference_native._LOCK:
        saved = reference_native._LIB
        reference_native._LIB = None
        reference_native._LIB_ERR = OSError("a half-written _sah.so")
    try:
        assert not reference_native.sah_available()
        ensure_reference_sah()
    finally:
        with reference_native._LOCK:
            if reference_native._LIB is None:
                reference_native._LIB, reference_native._LIB_ERR = saved, None
    assert reference_native.sah_available()
    scene, _, _, _ = bench.build_bench_scene(N_TRIS)
    for field in ("rows8", "meta"):
        a = np.asarray(getattr(scene.triangles, field))
        assert a.tobytes() == getattr(torch_scene.triangles, field).numpy().tobytes(), field


def test_triangle_statics_and_area(jax_scene, torch_scene):
    jt, tt = jax_scene.triangles, torch_scene.triangles
    assert tt.stack_depth == jt.stack_depth
    assert (tt.has_normals, tt.has_uv) == (jt.has_normals, jt.has_uv)
    np.testing.assert_allclose(tt.tri_area.numpy(), np.asarray(jt.tri_area), rtol=TABLE_RTOL)


@pytest.mark.parametrize(
    "field",
    ["materials.kind", "materials.reflectance", "lights.kind", "lights.spectrum",
     "lights.scale", "lights.shape_idx", "lights.shape_kind", "lights.two_sided",
     "lights.scene_radius", "light_sample_weights"],
)
def test_material_and_light_tables(jax_scene, torch_scene, field):
    group, _, name = field.rpartition(".")
    j = getattr(getattr(jax_scene, group), name) if group else getattr(jax_scene, name)
    t = getattr(getattr(torch_scene, group), name) if group else getattr(torch_scene, name)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TABLE_RTOL)


def test_census(jax_scene, torch_scene):
    for key in ("material_kinds", "light_kinds", "n_lights", "uniform_infinite_indices"):
        assert getattr(torch_scene, key) == getattr(jax_scene, key), key


def test_power_light_sampler_weights(jax_scene, torch_scene):
    def lights(n_tri, cs, lt_mod):
        return [
            {"kind": lt_mod.AREA, "spectrum": ConstantSpectrum(1.0), "scale": 15.0,
             "shape_kind": 1, "shape_idx": n_tri - 2 + k}
            for k in range(2)
        ] + [{"kind": lt_mod.UNIFORM_INFINITE, "spectrum": cs.illuminant,
              "photometric": True, "scale": 0.3}]

    n_tri = int(torch_scene.triangles.orig_indices.shape[0])
    mats = [dict(m) for m in bench_scene.BENCH_MATERIALS]
    js = jax_build_scene(triangles=jax_scene.triangles, materials=[dict(m) for m in mats],
                         lights=lights(n_tri, jax_cs("srgb"), jlt), light_sampler="power")
    ts = torch_build_scene(torch_scene.triangles, materials=mats,
                           lights=bench_scene.bench_lights(n_tri, torch_cs("srgb")),
                           light_sampler="power")
    np.testing.assert_allclose(
        ts.light_sample_weights.numpy(), np.asarray(js.light_sample_weights), rtol=TABLE_RTOL
    )


def test_scene_from_numpy_round_trip(jax_scene, torch_scene):
    arrays, census = jax_scene_to_numpy(jax_scene)
    conv = scene_from_numpy(arrays, census, device="cpu")
    for f in BIT_EQUAL_FIELDS + ["p", "n", "uv", "tri_area"]:
        np.testing.assert_array_equal(
            getattr(conv.triangles, f).numpy(), getattr(torch_scene.triangles, f).numpy()
        )
    assert conv.triangles.stack_depth == torch_scene.triangles.stack_depth
    np.testing.assert_array_equal(conv.materials.reflectance.numpy(),
                                  torch_scene.materials.reflectance.numpy())
    np.testing.assert_allclose(conv.lights.spectrum.numpy(), torch_scene.lights.spectrum.numpy(),
                               rtol=TABLE_RTOL)
    assert conv.light_kinds == torch_scene.light_kinds
    assert conv.device == torch.device("cpu")


def test_scene_from_numpy_mt_leaves(jax_scene, torch_scene):
    """The reference's rows always hold watertight leaves; carried across
    for Moller-Trumbore they are repacked as the port's builder packs them."""
    arrays, census = jax_scene_to_numpy(jax_scene)
    mt = TraverseConfig("v1", "mt", "slot")
    conv = scene_from_numpy(arrays, census, device="cpu")
    assert conv.triangles.traverse.leaf == "watertight"
    conv_mt = conv.triangles.with_traverse(mt)
    assert conv_mt.traverse == mt
    own = torch_scene.triangles.with_traverse(mt)
    assert conv_mt.rows8.numpy().tobytes() == own.rows8.numpy().tobytes()
    assert own.rows8.numpy().tobytes() != torch_scene.triangles.rows8.numpy().tobytes()


@pytest.mark.parametrize(
    "change",
    [{"has_spheres": True}, {"material_kinds": (0, 1)}, {"light_kinds": (0, 3)},
     {"image_infinite_indices": (1,)}, {"camera_medium": 0}],
    ids=["spheres", "conductor", "point_light", "image_light", "medium"],
)
def test_scene_from_numpy_refuses_unported(jax_scene, change):
    arrays, census = jax_scene_to_numpy(jax_scene)
    census.update(change)
    with pytest.raises(NotImplementedError):
        scene_from_numpy(arrays, census, device="cpu")


def test_builders_refuse_unported():
    with pytest.raises(NotImplementedError):
        tmtl.make_material_table([{"kind": tmtl.CONDUCTOR}], device="cpu")
    cam, _ = bench_scene.bench_camera_film((8, 8))
    tris = build_triangle_scene(bench_scene.bench_meshes(20, cam.camera_transform.render_from_world()),
                                device="cpu")
    with pytest.raises(NotImplementedError):
        torch_build_scene(tris, materials=[{"kind": 0}],
                          lights=[{"kind": tlt.POINT, "spectrum": ConstantSpectrum(1.0)}])
