"""Scene tables of the port against the reference, on the bench geometry
at 1,280 triangles plus the floor and light quads: the BVH tables are
bit-equal (both packages run the same numpy / native builder), material
and light tables agree to rtol 1e-6, and scene_from_numpy carries a
reference Scene across unchanged."""

import dataclasses

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
    "change, error",
    [({"has_patches": True}, (ValueError, "no patch table")),
     ({"has_instanced": True}, (ValueError, "no instance table")),
     ({"material_kinds": (0, 1), "materials.tex_reflectance": 0},
      (ValueError, "no texture table")),
     ({"image_infinite_indices": (1,)}, (ValueError, "no env table")),
     ({"camera_medium": 0}, (ValueError, "no media table"))],
    ids=["patches_without_table", "instanced_without_table",
         "conductor", "image_light", "medium"],
)
def test_scene_from_numpy_refuses_unported(jax_scene, change, error):
    """Each case asks for something still unported, or for textures, an
    image light, media, patches or instances without their tables: since
    the texture slice a textured conductor and an image light convert
    (tests/test_torch_env.py renders one), since the media slice media and
    delta lights do (test_scene_from_numpy_converts_delta_lights_and_media)
    and since the instancing slice patches and instances do
    (test_scene_from_numpy_converts_patches_and_instances), so their cases
    here lack the tables they index.  Spheres convert since they were
    ported (tests/test_torch_scene_union.py)."""
    arrays, census = jax_scene_to_numpy(jax_scene)
    for key, value in change.items():
        if key in arrays:
            arrays[key] = np.full_like(arrays[key], value)
        else:
            census[key] = value
    with pytest.raises(error[0], match=error[1]):
        scene_from_numpy(arrays, census, device="cpu")


def test_scene_from_numpy_carries_differentiable_hits(jax_scene):
    """Since the gradient slice the census flag ``differentiable_hits``
    converts (it was refused before): the flag is carried across and the
    tables are unchanged."""
    arrays, census = jax_scene_to_numpy(jax_scene)
    assert scene_from_numpy(arrays, census, device="cpu").triangles.differentiable_hits is False
    census["triangles.differentiable_hits"] = True
    conv = scene_from_numpy(arrays, census, device="cpu")
    assert conv.triangles.differentiable_hits is True
    assert np.array_equal(conv.triangles.rows8.numpy(), arrays["triangles.rows8"])


@pytest.mark.parametrize("group", ["patches", "instanced"])
def test_scene_from_numpy_converts_patches_and_instances(jax_scene, group):
    """A reference scene with bilinear patches (a patch area light among
    them, under the power sampler) or with instances of a small object
    beside the bench triangles, carried across: every table byte for byte
    and the census."""
    from shimmer_tpu.shapes.instanced import build_instanced as jax_build_instanced
    from shimmer_tpu.spectra.spectrum import ConstantSpectrum as JaxConstant

    kw = {}
    lights = [{"kind": jlt.UNIFORM_INFINITE, "spectrum": JaxConstant(0.5)}]
    if group == "patches":
        kw["patches"] = [
            {"p00": (-1, 0, -1), "p10": (1, 0, -1), "p01": (-1, 0.3, 1), "p11": (1, 0, 1),
             "uv": ((0, 0), (2, 0), (0, 1), (2, 1)), "material_id": 0},
            {"p00": (-0.5, 2, -0.5), "p10": (0.5, 2, -0.5), "p01": (-0.5, 2, 0.5),
             "p11": (0.5, 2, 0.5), "material_id": 0, "area_light_id": 1, "reverse": True},
        ]
        lights.append({"kind": jlt.AREA, "spectrum": JaxConstant(3.0), "shape_kind": 2,
                       "shape_idx": 1})
    else:
        obj = bench.make_displaced_sphere(80)
        m = np.eye(4)
        m[:3, 3] = (2.0, 0.0, 1.0)
        kw["instanced"] = jax_build_instanced(
            [[{"p": obj[0], "indices": obj[1], "material_id": 0}]],
            [(0, np.diag([0.3, 0.3, 0.3, 1.0])), (0, m)])
    jsc = jax_build_scene(triangles=jax_scene.triangles, materials=[{"kind": 0}],
                          lights=lights, light_sampler="power", **kw)
    arrays, census = jax_scene_to_numpy(jsc)
    conv = scene_from_numpy(arrays, census, device="cpu")
    assert (conv.has_patches, conv.has_instanced) == (group == "patches", group == "instanced")
    obj = getattr(conv, group)
    for f in dataclasses.fields(obj):
        got = getattr(obj, f.name)
        if isinstance(got, torch.Tensor):
            key = f"{group}.{f.name}"
            assert got.numpy().tobytes() == np.ascontiguousarray(arrays[key],
                                                                got.numpy().dtype).tobytes(), key
        else:
            assert got == census[f"{group}.{f.name}"], f.name
    np.testing.assert_array_equal(conv.light_sample_weights.numpy(), arrays["light_sample_weights"])
    np.testing.assert_array_equal(conv.lights.scene_radius.numpy(), arrays["lights.scene_radius"])


@pytest.mark.parametrize("camera_medium", [-1, 0], ids=["interface", "camera_medium"])
def test_scene_from_numpy_converts_delta_lights_and_media(jax_scene, camera_medium):
    """A point, a spot and a distant light beside the bench lights, and two
    media (the camera's, or interface media on the bench triangles),
    carried across: every light column, the media tables and the census."""
    from shimmer_tpu.spectra.spectrum import ConstantSpectrum as JaxConstant
    from shimmer_tpu.shapes.triangle import build_triangle_scene as jax_build_tris

    mesh = {**bench_scene.bench_meshes(20, bench_scene.bench_camera_film((8, 8))[0]
                                       .camera_transform.render_from_world())[0],
            "medium_inside": 1, "medium_outside": camera_medium}
    lights = [
        {"kind": jlt.POINT, "spectrum": JaxConstant(2.0), "position": (0.0, 2.0, 0.0)},
        {"kind": jlt.SPOT, "spectrum": JaxConstant(3.0), "position": (1.0, 2.0, 0.0),
         "direction": (0.0, -1.0, 0.2), "cone_angle": 20.0, "cone_delta": 4.0},
        {"kind": jlt.DISTANT, "spectrum": JaxConstant(1.0), "direction": (0.2, -1.0, 0.1)},
    ]
    media = [{"sigma_a": (0.1, 0.2, 0.3), "sigma_s": 0.5, "g": 0.4}, {"sigma_a": 0.0}]
    jsc = jax_build_scene(triangles=jax_build_tris([mesh]), materials=[{"kind": 0}],
                          lights=lights, light_sampler="power", media=media,
                          camera_medium=camera_medium)
    arrays, census = jax_scene_to_numpy(jsc)
    conv = scene_from_numpy(arrays, census, device="cpu")
    assert conv.light_kinds == (jlt.POINT, jlt.DISTANT, jlt.SPOT)
    assert (conv.camera_medium, conv.has_interface_media) == (camera_medium, True)
    assert conv.triangles.has_iface_media
    for group, obj in (("lights", conv.lights), ("media", conv.media)):
        for f in dataclasses.fields(obj):
            key = f"{group}.{f.name}"
            got = getattr(obj, f.name).numpy()
            assert got.tobytes() == np.ascontiguousarray(arrays[key], got.dtype).tobytes(), key


def test_builders_refuse_unported():
    # A textured conductor builds since the texture slice
    # (test_torch_materials.py::test_textured_material_table_matches_reference);
    # diffuse transmission has no BxDF in either package.
    with pytest.raises(NotImplementedError):
        tmtl.make_material_table([{"kind": tmtl.DIFFUSE_TRANSMISSION}], device="cpu")
    cam, _ = bench_scene.bench_camera_film((8, 8))
    tris = build_triangle_scene(bench_scene.bench_meshes(20, cam.camera_transform.render_from_world()),
                                device="cpu")
    # Every light kind builds since the media slice, and an area light on
    # a bilinear patch (shape kind 2) since the instancing slice
    # (test_torch_bilinear.py::test_build_scene_patch_light_matches_reference);
    # a shape kind that neither package has does not.
    with pytest.raises(NotImplementedError):
        torch_build_scene(tris, materials=[{"kind": 0}],
                          lights=[{"kind": tlt.AREA, "spectrum": ConstantSpectrum(1.0),
                                   "shape_kind": 7, "shape_idx": 0}])


@pytest.mark.parametrize("variant", list(bench_scene.MATERIAL_VARIANTS))
def test_material_tables_match_reference(jax_scene, variant):
    """The material bench scene's tables: the reference's build_scene over
    the same material dicts and dense spectra table, carried across by
    scene_from_numpy (every MaterialTable column, the census flags and
    spectra_table) and built by the port's own builder, agree."""
    jm = jax_build_scene(
        triangles=jax_scene.triangles,
        materials=bench_scene.material_bench_materials(variant),
        spectra_table=bench_scene.material_bench_spectra(),
    )
    arrays, census = jax_scene_to_numpy(jm)
    conv = scene_from_numpy(arrays, census, device="cpu")
    own = torch_build_scene(
        build_triangle_scene(bench_scene.bench_meshes(20, bench_scene.bench_camera_film((8, 8))[0]
                                                      .camera_transform.render_from_world()),
                             device="cpu"),
        materials=bench_scene.material_bench_materials(variant),
        spectra_table=bench_scene.material_bench_spectra(),
    )
    kinds = tuple(sorted({m["kind"] for m in bench_scene.material_bench_materials(variant)}))
    assert conv.material_kinds == own.material_kinds == kinds
    for field in dataclasses.fields(tmtl.MaterialTable):
        if field.name == "textured_params":  # the port's census: nothing textured here
            assert conv.materials.textured_params == own.materials.textured_params == ()
            continue
        ref = getattr(jm.materials, field.name)
        for port in (conv.materials, own.materials):
            got = getattr(port, field.name)
            if isinstance(ref, bool):
                assert got == ref, field.name
                continue
            ref = np.asarray(ref)
            assert got.dtype == {"f": torch.float32, "i": torch.int32, "b": torch.bool}[ref.dtype.kind]
            np.testing.assert_allclose(got.numpy(), ref, rtol=TABLE_RTOL, err_msg=field.name)
    assert conv.materials.has_dispersion and not conv.materials.layer_medium
    for port in (conv, own):
        assert port.spectra_table.dtype == torch.float32
        np.testing.assert_array_equal(port.spectra_table.numpy(), np.asarray(jm.spectra_table))
