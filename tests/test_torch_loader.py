"""The port's pbrt-v4 loader (shimmer_tpu_torch/loading/, shapes/mesh.py
read_ply) against the reference's, on the CPU.

- The parse cases of tests/test_parser.py run against the port, on copies
  of their scene texts (the JAX test module is not imported).  Cases whose
  scenes use only ported features give the reference's result: since the
  texture slice, the texture and image environment light cases too (their
  image files written here, as PNG and as PFM), with texture and env
  tables equal to the reference loader's, and since the instancing slice
  the instancing and bilinear mesh cases (instance, patch and light
  tables byte-equal), and since the megakernel slice the jitter-option,
  render-space and independent-sampler cases, whose jobs equal the
  reference loader's (tests/test_parser.py:403, :459 and the CORNELL
  scene).
- For each golden scene (tests/scenes/*.pbrt) the port's
  ``SceneBuilder.create()`` gives the reference's tables: ``rows8`` and the
  other triangle tables byte-equal, the sphere table, materials, lights,
  light weights and spectra equal, camera rays within 1e-6, and the same
  film and sampler settings.
- ``read_ply`` equals the reference's on ascii, binary little-endian and
  binary big-endian files with normals, uvs, triangles and quads.
- Every unported directive, parameter and option raises
  NotImplementedError naming it.  Each refusal the megakernel slice lifted
  (the other cameras, the lens, screen window and shutter, the other
  filters and samplers, simplepath and randomwalk, the film's ISO and
  white balance, the render spaces, the jitter options, ColorSpace) is a
  case whose loaded job equals the reference loader's: scene tables
  (``rows8`` byte-equal), camera rays and differentials, sampler draws,
  the filter's table, the sensor matrix, the integrator and the options.
"""

import struct
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shimmer_tpu.loading.parser import parse_file as jax_parse_file
from shimmer_tpu.loading.parser import parse_str as jax_parse
from shimmer_tpu.loading.scene_builder import SceneBuilder as JaxBuilder
from shimmer_tpu.shapes.mesh import read_ply as jax_read_ply
from shimmer_tpu_torch.film.image import Image as TImage
from shimmer_tpu_torch.loading.errors import DirectiveError, ParameterError, SceneLoadError, TokenError
from shimmer_tpu_torch.loading.parser import parse_file, parse_str
from shimmer_tpu_torch.loading.scene_builder import SceneBuilder
from shimmer_tpu_torch.loading.tokenizer import tokenize
from shimmer_tpu_torch.materials import material as mtl
from shimmer_tpu_torch.shapes.mesh import read_ply
from torch_parity import ensure_reference_sah, jax_scene_to_numpy

torch.set_num_threads(1)

SCENES_DIR = Path(__file__).parent / "scenes"
GOLDEN = ["diffuse_box", "conductor_env", "dielectric"]

# tests/test_parser.py's CORNELL scene.
CORNELL = """
Integrator "path" "integer maxdepth" [4]
Sampler "independent" "integer pixelsamples" [8]
Film "rgb" "integer xresolution" [32] "integer yresolution" [32]
    "string filename" "cornell.pfm"
PixelFilter "box"
Camera "perspective" "float fov" [50]

WorldBegin

MakeNamedMaterial "white" "string type" "diffuse"
    "rgb reflectance" [0.73 0.73 0.73]
MakeNamedMaterial "red" "string type" "diffuse"
    "rgb reflectance" [0.65 0.05 0.05]

# floor quad
NamedMaterial "white"
Shape "trianglemesh"
    "integer indices" [0 1 2 0 2 3]
    "point3 P" [-1 0 -1  1 0 -1  1 0 1  -1 0 1]

AttributeBegin
  NamedMaterial "red"
  Translate 0 1 0
  Shape "sphere" "float radius" [0.4]
AttributeEnd

AttributeBegin
  AreaLightSource "diffuse" "rgb L" [10 10 10]
  Material "diffuse" "rgb reflectance" [0 0 0]
  Shape "trianglemesh"
    "integer indices" [0 1 2 0 2 3]
    "point3 P" [-0.3 1.99 -0.3  0.3 1.99 -0.3  0.3 1.99 0.3  -0.3 1.99 0.3]
AttributeEnd

LightSource "infinite" "rgb L" [0.1 0.1 0.1]
"""
CORNELL_ZSOBOL = CORNELL.replace('Sampler "independent"', 'Sampler "zsobol"')

# tests/test_parser.py TestOptionAttribute.BASE, and the same header
# without its jitter option.
OPTION_BASE = """
Option "integer seed" [7] "bool disablepixeljitter" true
Camera "perspective" "float fov" [45]
Film "rgb" "integer xresolution" [8] "integer yresolution" [8]
Sampler "independent" "integer pixelsamples" [2]
Integrator "path"
WorldBegin
%s
"""
OPTION_BASE_PORTED = (OPTION_BASE.replace(' "bool disablepixeljitter" true', "")
                      .replace('"independent"', '"zsobol"'))


def both(text, search_dir=None):
    """The reference's and the port's builders after parsing ``text``."""
    jb, tb = JaxBuilder(search_dir=search_dir), SceneBuilder(search_dir=search_dir)
    jax_parse(text, jb, search_dir=search_dir)
    parse_str(text, tb, search_dir=search_dir)
    return jb, tb


# --- tokenizer ---


def test_tokenizer_cases():
    toks = [t for t, _ in tokenize('Shape "sphere" "float radius" [1.5] # c\nScale 1 2 3')]
    assert toks == ["Shape", '"sphere"', '"float radius"', "[", "1.5", "]", "Scale", "1", "2", "3"]
    assert [t for t, _ in tokenize('"string filename" "my file.png"')] == [
        '"string filename"', '"my file.png"']
    assert [loc.line for _, loc in tokenize("A\nB\nC")] == [1, 2, 3]


@pytest.mark.parametrize("name", GOLDEN)
def test_tokenizer_matches_reference_on_golden_files(name):
    from shimmer_tpu.loading.tokenizer import tokenize as jax_tokenize

    text = (SCENES_DIR / f"{name}.pbrt").read_text()
    assert [(t, str(loc)) for t, loc in tokenize(text, name)] == [
        (t, str(loc)) for t, loc in jax_tokenize(text, name)]


# --- the parse cases of tests/test_parser.py ---


def test_cornell_structure():
    jb, b = both(CORNELL)
    assert b.integrator_spec[0] == "path"
    assert b.integrator_spec[1].get_one_int("maxdepth", 0) == 4
    assert b.sampler_spec[1].get_one_int("pixelsamples", 0) == 8
    assert len(b.shapes) == 3
    assert b.shapes[1]["kind"] == "sphere"
    assert b.shapes[2]["area_light"] is not None
    assert len(b.lights) == 1
    assert "white" in b.named_materials and "red" in b.named_materials
    assert [s["kind"] for s in b.shapes] == [s["kind"] for s in jb.shapes]
    for s, js in zip(b.shapes, jb.shapes):
        np.testing.assert_array_equal(s["ctm"], js["ctm"])
        assert s["material"] == js["material"]
    assert b.named_materials == jb.named_materials


def test_graphics_state_restored():
    text = """
        WorldBegin
        Material "diffuse" "rgb reflectance" [1 0 0]
        AttributeBegin
          Material "diffuse" "rgb reflectance" [0 1 0]
          Translate 5 0 0
          Shape "sphere"
        AttributeEnd
        Shape "sphere"
        """
    jb, b = both(text)
    s_inner, s_outer = b.shapes
    assert s_inner["material"] != s_outer["material"]
    assert np.isclose(s_inner["ctm"][0, 3], 5.0)
    assert np.isclose(s_outer["ctm"][0, 3], 0.0)
    assert [s["material"] for s in b.shapes] == [s["material"] for s in jb.shapes]


def test_transform_directives():
    jb, b = both("Translate 1 2 3\nScale 2 2 2\nRotate 90 0 0 1\nConcatTransform "
                 "[1 0 0 0 0 1 0 0 0 0 1 0 1 1 1 1]\nCoordinateSystem \"mine\"\nWorldBegin\n"
                 "CoordSysTransform \"mine\"\n")
    np.testing.assert_array_equal(b.gs.ctm, jb.gs.ctm)
    np.testing.assert_array_equal(b.named_coords["mine"], jb.named_coords["mine"])
    b2 = SceneBuilder()
    parse_str("Translate 1 2 3\nScale 2 2 2\nRotate 90 0 0 1\nWorldBegin\n", b2)
    np.testing.assert_allclose(b2.gs.ctm, np.eye(4))


def test_include(tmp_path):
    (tmp_path / "inc.pbrt").write_text('Shape "sphere" "float radius" [2]\n')
    (tmp_path / "imp.pbrt").write_text('Shape "sphere" "float radius" [3]\n')
    b = SceneBuilder(search_dir=tmp_path)
    parse_str('WorldBegin\nInclude "inc.pbrt"\nImport "imp.pbrt"\n', b, search_dir=tmp_path)
    assert [s["pd"].get_one_float("radius", 0) for s in b.shapes] == [2.0, 3.0]


def test_spectrum_params():
    b = SceneBuilder()
    parse_str('WorldBegin\nMaterial "conductor" "spectrum eta" "metal-Au-eta" '
              '"spectrum k" "metal-Au-k"\nShape "sphere"\n', b)
    assert b.materials[-1]["kind_name"] == "conductor"


def test_cornell_with_zsobol_creates_the_reference_tables():
    """The Cornell case with the port's sampler: the reference's tables
    (its own test renders it; the golden tests below render here)."""
    ensure_reference_sah()
    jb, b = both(CORNELL_ZSOBOL)
    job, jjob = b.create(device="cpu"), jb.create()
    assert job.max_depth == 4 and job.film.resolution == (32, 32)
    assert job.scene.n_lights == 3 and job.filename == "cornell.pfm"
    assert_scene_tables_equal(job.scene, jjob.scene)


def test_dielectric_material_conversion():
    ensure_reference_sah()
    text = 'WorldBegin\nMaterial "dielectric" "float eta" [1.33]\nShape "sphere"\nLightSource "infinite"\n'
    jb, b = both(text)
    job, jjob = b.create(device="cpu"), jb.create()
    kinds = job.scene.materials.kind.numpy()
    assert mtl.DIELECTRIC in kinds
    eta = job.scene.materials.eta_float.numpy()
    assert np.isclose(eta[kinds == mtl.DIELECTRIC][0], 1.33)
    assert not job.scene.has_triangles
    assert_scene_tables_equal(job.scene, jjob.scene)


def test_attribute_scoped_defaults_and_priority():
    b = SceneBuilder()
    parse_str(OPTION_BASE_PORTED % 'AttributeBegin\nAttribute "shape" "float radius" [3.5]\n'
              'Shape "sphere"\nAttributeEnd\nShape "sphere"\n', b)
    assert [s["pd"].get_one_float("radius", 1.0) for s in b.shapes] == [3.5, 1.0]
    b = SceneBuilder()
    parse_str(OPTION_BASE_PORTED % 'Attribute "shape" "float radius" [3.5]\n'
              'Shape "sphere" "float radius" [2.0]\n', b)
    assert b.shapes[0]["pd"].get_one_float("radius", 1.0) == 2.0
    job = b.create(device="cpu")
    assert job.sampler.seed == 7


def test_typed_errors():
    with pytest.raises(DirectiveError) as ei:
        parse_str("WorldBegin\nFrobnicate\n", SceneBuilder())
    assert issubclass(DirectiveError, SceneLoadError) and "Frobnicate" in str(ei.value)
    with pytest.raises(TokenError):
        parse_str('Camera "persp\n', SceneBuilder())
    with pytest.raises(ParameterError):
        parse_str('WorldBegin\nShape "sphere" "floot radius" [1]\n', SceneBuilder())


def test_option_forcediffuse():
    b = SceneBuilder()
    parse_str('Option "bool forcediffuse" true\nCamera "perspective"\n'
              'Film "rgb" "integer xresolution" [8] "integer yresolution" [8]\n'
              'Sampler "zsobol" "integer pixelsamples" [2]\nIntegrator "path"\nWorldBegin\n'
              'Material "conductor"\nShape "sphere" "float radius" [1]\n', b)
    assert tuple(b.create(device="cpu").scene.material_kinds) == (mtl.DIFFUSE,)


_TEXTURE_SCENE = ('Camera "perspective"\nFilm "rgb" "integer xresolution" [4] '
                  '"integer yresolution" [4]\nWorldBegin\n'
                  'Texture "checker" "float" "constant" "float value" [0.25]\n'
                  'Material "diffuse" "texture roughness" "checker"\nShape "sphere"\n')
_BILINEAR_SCENE = textwrap.dedent("""
    Film "rgb" "integer xresolution" [16] "integer yresolution" [16]
    Sampler "zsobol" "integer pixelsamples" [2]
    WorldBegin
    Material "diffuse" "rgb reflectance" [0.5 0.5 0.5]
    Shape "bilinearmesh" "integer indices" [0 1 2 3]
        "point3 P" [-1 -1 2   1 -1 2   -1 1 2   1 1 2]
    """)
_ENV_SCENE = """
LookAt 0 0 -5  0 0 0  0 1 0
Camera "perspective" "float fov" [40]
Sampler "zsobol" "integer pixelsamples" [2]
WorldBegin
LightSource "infinite" "string filename" ["sky.pfm"]
Shape "sphere"
"""


def _assert_jobs_equal(job, jjob, draws=True):
    """The port's job equals the reference loader's: scene tables, camera
    rays and differentials (within 1e-6: einsum against the spelled-out
    sum, and an ulp of trig), sampler draws (bit-equal), filter (radius,
    integral, table byte-equal where its values are), sensor and film
    matrices, integrator, depth, spp and the jitter options."""
    assert_scene_tables_equal(job.scene, jjob.scene)
    assert (job.integrator, job.max_depth, job.spp, job.disable_pixel_jitter,
            job.disable_wavelength_jitter) == (
        jjob.integrator, jjob.max_depth, jjob.spp, jjob.disable_pixel_jitter,
        jjob.disable_wavelength_jitter)
    assert type(job.camera).__name__ == type(jjob.camera).__name__
    for attr in ("render_from_camera", "world_from_render"):
        np.testing.assert_array_equal(getattr(job.camera.camera_transform, attr).m,
                                      np.asarray(getattr(jjob.camera.camera_transform, attr).m))
    assert (job.camera.shutter_open, job.camera.shutter_close) == (
        jjob.camera.shutter_open, jjob.camera.shutter_close)
    w, h = job.film.resolution
    rng = np.random.default_rng(3)
    p_film = (rng.random((256, 2)) * [w, h]).astype(np.float32)
    u = rng.random((256, 2)).astype(np.float32)
    rd = job.camera.generate_ray_differential(torch.from_numpy(p_film), torch.from_numpy(u))
    jrd = jjob.camera.generate_ray_differential(jnp.asarray(p_film), jnp.asarray(u))
    for got, want in ((rd.ray.o, jrd.ray.o), (rd.ray.d, jrd.ray.d), (rd.rx_d, jrd.rx_d),
                      (rd.ry_o, jrd.ry_o)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    f, jf = job.film.filter, jjob.film.filter
    assert type(f).__name__ == type(jf).__name__ and f.radius == tuple(jf.radius)
    assert job.film.filter_integral == pytest.approx(jjob.film.filter_integral, rel=1e-6)
    if type(f).__name__ == "MitchellFilter":
        for field in ("func", "cond_cdf", "marg_cdf"):
            assert (getattr(f._dist, field).numpy().tobytes()
                    == np.asarray(getattr(jf._dist, field)).tobytes()), field
    sensor, jsensor = job.film.sensor, jjob.film.sensor
    assert sensor.imaging_ratio == jsensor.imaging_ratio
    np.testing.assert_array_equal(sensor.xyz_from_sensor_rgb, jsensor.xyz_from_sensor_rgb)
    np.testing.assert_array_equal(job.film.output_rgb_from_sensor_rgb,
                                  jjob.film.output_rgb_from_sensor_rgb)
    s, js = job.sampler, jjob.sampler
    assert type(s).__name__ == type(js).__name__
    assert (s.samples_per_pixel, s.seed) == (js.samples_per_pixel, js.seed)
    if draws:
        px = np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1).reshape(-1, 2).astype(np.int32)
        st = s.start_pixel_sample(torch.from_numpy(px), torch.tensor(1))
        jst = js.start_pixel_sample(jnp.asarray(px), jnp.uint32(1))
        for _ in range(3):
            u2, st = s.get_2d(st)
            ju2, jst = js.get_2d(jst)
            np.testing.assert_array_equal(u2.numpy(), np.asarray(ju2))


@pytest.mark.parametrize(
    "text",
    [
        # :403, the seed and the jitter option (every TestOptionAttribute
        # header has it), with the independent sampler.
        OPTION_BASE % 'Shape "sphere" "float radius" [1]',
        # :459, the camera render space: render_from_camera is the identity.
        ('Option "string rendercoordsys" ["camera"]\n' + OPTION_BASE)
        % 'Shape "sphere" "float radius" [1]',
        # TestCreate / the CLI case: the independent sampler.
        CORNELL,
    ],
    ids=["jitter_option", "rendercoordsys", "independent_sampler"],
)
def test_parse_cases_with_lifted_options_load(text):
    ensure_reference_sah()
    jb, b = both(text)
    job, jjob = b.create(device="cpu"), jb.create()
    _assert_jobs_equal(job, jjob)
    if "disablepixeljitter" in text:
        assert job.disable_pixel_jitter and not job.disable_wavelength_jitter
        assert job.sampler.seed == 7
    if "rendercoordsys" in text:
        np.testing.assert_allclose(job.camera.camera_transform.render_from_camera.m, np.eye(4),
                                   atol=1e-6)


# test_parser.py:119 (test_object_instancing) and :267 (the bilinear mesh
# scene), which raised before the instancing slice: each now loads with the
# reference's tables.
_INSTANCING_SCENE = """
WorldBegin
ObjectBegin "tree"
  Shape "sphere" "float radius" [0.5]
  Shape "trianglemesh"
    "integer indices" [0 1 2]
    "point3 P" [0 0 0  1 0 0  0 1 0]
ObjectEnd
ObjectInstance "tree"
Translate 3 0 0
ObjectInstance "tree"
"""


@pytest.mark.parametrize("text", [_INSTANCING_SCENE, _BILINEAR_SCENE],
                         ids=["instancing", "bilinearmesh"])
def test_parse_cases_with_lifted_features_load(text):
    ensure_reference_sah()
    jb, b = both(text)
    scene = b.create(device="cpu").scene
    assert_scene_tables_equal(scene, jb.create().scene)
    if "ObjectBegin" in text:
        # The spheres are copied per instance; the triangle mesh is not.
        assert len(b.shapes) == 2 and all(r["kind"] == "sphere" for r in b.shapes)
        assert [float(ctm[0, 3]) for _, ctm in b.instances] == [0.0, 3.0]
        assert scene.has_instanced and int(scene.instanced.inst_fwd.shape[0]) == 2
        assert not scene.has_triangles
    else:
        assert scene.has_patches and int(scene.patches.p00.shape[0]) == 1


@pytest.mark.parametrize("case", ["textures", "image_env"])
def test_parse_cases_with_textures_match_reference(tmp_path, case):
    """The two parse cases that raised before the texture slice: :201's
    texture directive (a float texture as a diffuse roughness, which the
    reference reads into the roughness texture columns) and :347's image
    environment light, its sky written here as PFM."""
    ensure_reference_sah()
    if case == "image_env":
        TImage(np.full((16, 32, 3), 0.5, np.float32)).write(tmp_path / "sky.pfm")
    jb, b = both(_TEXTURE_SCENE if case == "textures" else _ENV_SCENE, search_dir=tmp_path)
    job = b.create(device="cpu")
    assert_scene_tables_equal(job.scene, jb.create().scene)
    if case == "textures":
        assert "checker" in b.float_textures
        assert job.scene.materials.tex_uroughness.tolist() == [-1, 0]
    else:
        assert job.scene.image_infinite_indices == (0,)


# test_parser.py's TestEnvScene text (:315), with the zsobol sampler.
def _env_scene_text(pfm_name, span):
    return f"""
LookAt 0 0 -5  0 0 0  0 1 0
Camera "perspective" "float fov" [40]
Film "rgb" "integer xresolution" [16] "integer yresolution" [16]
Sampler "zsobol" "integer pixelsamples" [2]
Integrator "path" "integer maxdepth" [3]
WorldBegin
LightSource "infinite" "string filename" ["{pfm_name}"]
AttributeBegin
Material "diffuse" "rgb reflectance" [0.5 0.5 0.5]
Shape "trianglemesh"
  "point3 P" [-{span} -1 -{span}  {span} -1 -{span}  {span} -1 {span}  -{span} -1 {span}]
  "integer indices" [0 1 2 0 2 3]
AttributeEnd
"""


def test_env_scene_radius_from_bounds(tmp_path):
    """test_parser.py's test_scene_radius_from_bounds: a lat-long map,
    converted, with the light's radius from the geometry."""
    ensure_reference_sah()
    TImage(np.full((32, 64, 3), 0.5, np.float32)).write(tmp_path / "sky.pfm")
    jb, b = both(_env_scene_text("sky.pfm", 800.0), search_dir=tmp_path)
    job = b.create(device="cpu")
    assert float(job.scene.env.scene_radius) > 800.0
    assert float(job.scene.lights.scene_radius) > 800.0
    assert_scene_tables_equal(job.scene, jb.create().scene)


def test_equirect_env_renders(tmp_path):
    """test_parser.py's test_equirect_env_renders on the port: a bright
    horizon band; the image is finite and lit."""
    from shimmer_tpu_torch.render import render

    img = np.zeros((32, 64, 3), np.float32)
    img[12:20] = 2.0
    TImage(img).write(tmp_path / "sky.pfm")
    b = SceneBuilder(search_dir=tmp_path)
    parse_str(_env_scene_text("sky.pfm", 4.0), b, search_dir=tmp_path)
    job = b.create(device="cpu")
    out, _ = render(job.scene, job.camera, job.film, job.sampler, spp=job.spp,
                    max_depth=job.max_depth)
    assert np.isfinite(out.numpy()).all() and float(out.mean()) > 0.0


def test_directionmix_texture_parses():
    """test_parser.py's test_directionmix_texture_parses."""
    from shimmer_tpu_torch.textures import textures as tx

    b = SceneBuilder()
    parse_str('Camera "perspective"\n'
              'Film "rgb" "integer xresolution" [4] "integer yresolution" [4]\n'
              'Sampler "zsobol" "integer pixelsamples" [1]\nWorldBegin\n'
              'Texture "dm" "spectrum" "directionmix"\n  "rgb tex1" [1 0 0] "rgb tex2" [0 0 1]\n'
              '  "vector3 dir" [0 0 1]\n'
              'Material "diffuse" "texture reflectance" "dm"\n'
              'Shape "sphere" "float radius" [1]\n', b)
    table = b.create(device="cpu").scene.textures
    assert tx.DIRECTION_MIX in table.kinds_present
    row = int(np.nonzero(table.kind.numpy() == tx.DIRECTION_MIX)[0][0])
    np.testing.assert_allclose(table.mix_dir.numpy()[row], [0.0, 0.0, 1.0])


def test_mix_material_textured_amount():
    """test_parser.py's test_mix_material_textured_amount."""
    b = SceneBuilder()
    parse_str('Camera "perspective"\n'
              'Film "rgb" "integer xresolution" [4] "integer yresolution" [4]\n'
              'Sampler "zsobol" "integer pixelsamples" [1]\nWorldBegin\n'
              'Texture "amt" "float" "constant" "float value" [0.25]\n'
              'MakeNamedMaterial "ma" "string type" "diffuse"\n  "rgb reflectance" [0.8 0 0]\n'
              'MakeNamedMaterial "mb" "string type" "diffuse"\n  "rgb reflectance" [0 0 0.8]\n'
              'Material "mix" "string materials" ["ma" "mb"]\n  "texture amount" "amt"\n'
              'Shape "sphere" "float radius" [1]\n', b)
    mats = b.create(device="cpu").scene.materials
    assert mats.has_textured_mix
    assert int(mats.tex_mix_amount.max()) >= 0


def test_imagemap_mapping_param(tmp_path):
    """test_parser.py's test_imagemap_mapping_param (an absolute path)."""
    from shimmer_tpu_torch.textures import textures as tx

    path = tmp_path / "t.pfm"
    TImage(np.ones((4, 4, 3), np.float32) * 0.5).write(path)
    b = SceneBuilder()
    parse_str('Camera "perspective"\n'
              'Film "rgb" "integer xresolution" [4] "integer yresolution" [4]\nWorldBegin\n'
              f'Texture "cyl" "float" "imagemap" "string filename" "{path}"\n'
              '  "string mapping" "cylindrical"\n'
              'Material "diffuse"\nShape "sphere" "float radius" [1]\n', b)
    table = b.tex_builder.build(device="cpu")
    assert int(table.mapping.max()) == tx.MAP_CYLINDRICAL


TEXTURED_SCENE = """
LookAt 0 2 -4  0 0 0  0 1 0
Camera "perspective" "float fov" [45]
Film "rgb" "integer xresolution" [12] "integer yresolution" [8]
Sampler "zsobol" "integer pixelsamples" [2]
Integrator "path" "integer maxdepth" [4]
Option "bool disabletexturefiltering" true
WorldBegin
AttributeBegin
  Rotate 30 0 1 0
  LightSource "infinite" "string filename" "sky.png" "float scale" [1.5]
AttributeEnd
Texture "checks" "spectrum" "imagemap" "string filename" "checker.png"
    "string filter" "trilinear" "float uscale" [4] "float vscale" [4] "string wrap" "clamp"
Texture "rough" "float" "imagemap" "string filename" "rough.pfm" "string filter" "ewa"
Texture "bumps" "float" "imagemap" "string filename" "rough.pfm" "string filter" "bilinear"
    "bool invert" true "float scale" [0.05]
Texture "amt" "float" "imagemap" "string filename" "rough.pfm" "string filter" "point"
    "string wrap" "black"
Texture "half" "float" "constant" "float value" [0.5]
Texture "sc" "float" "scale" "texture tex" "rough" "texture scale" "half"
Texture "blend" "spectrum" "mix" "texture tex1" "checks" "rgb tex2" [0.2 0.3 0.4]
    "texture amount" "amt"
Texture "dm" "spectrum" "directionmix" "rgb tex1" [0.8 0.1 0.1] "rgb tex2" [0.1 0.1 0.8]
    "vector3 dir" [0 1 0]
AttributeBegin
  Translate 0.5 0 0
  Texture "cyl" "spectrum" "imagemap" "string filename" "checker.png"
      "string mapping" "cylindrical"
  Texture "pl" "float" "imagemap" "string filename" "rough.pfm" "string mapping" "planar"
      "vector3 v1" [1 0 0] "vector3 v2" [0 0 1] "float udelta" [0.25]
  Texture "sph" "spectrum" "imagemap" "string filename" "sky.png" "string mapping" "spherical"
AttributeEnd
MakeNamedMaterial "a" "string type" "diffuse" "texture reflectance" "dm"
MakeNamedMaterial "b" "string type" "conductor" "texture roughness" "sc"
Material "diffuse" "texture reflectance" "blend"
Shape "trianglemesh" "point3 P" [-3 0 -3 3 0 -3 3 0 3 -3 0 3] "integer indices" [0 1 2 0 2 3]
    "point2 uv" [0 0 1 0 1 1 0 1]
AttributeBegin
  Translate -1 0.6 0
  Material "conductor" "texture uroughness" "rough" "texture vroughness" "pl"
  Shape "sphere" "float radius" [0.6]
AttributeEnd
AttributeBegin
  Translate 1 0.6 0
  Material "coateddiffuse" "texture reflectance" "cyl" "texture displacement" "bumps"
  Shape "sphere" "float radius" [0.6]
AttributeEnd
AttributeBegin
  Translate 0 0.5 1.2
  Material "mix" "string materials" ["a" "b"] "texture amount" "amt"
  Shape "sphere" "float radius" [0.5]
AttributeEnd
AttributeBegin
  Material "dielectric" "texture roughness" "pl"
  Translate 0 1.5 0
  Shape "sphere" "float radius" [0.3]
AttributeEnd
"""


def _write_texture_files(d):
    from PIL import Image as PILImage

    rng = np.random.default_rng(12)
    yy, xx = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    c = ((xx // 2 + yy // 2) % 2).astype(np.uint8) * 200
    PILImage.fromarray(np.stack([c, 0 * c + 40, 255 - c], -1)).save(d / "checker.png")
    TImage(rng.uniform(0.05, 0.5, (8, 12)).astype(np.float32)).write(d / "rough.pfm")
    sky = np.full((8, 16, 3), 60, np.uint8)
    sky[1:3, 2:5] = 250
    PILImage.fromarray(sky).save(d / "sky.png")


def test_textured_scene_tables_match_reference(tmp_path):
    """One scene of every texture feature: PNG and PFM images, every
    mapping, filter and wrap mode, invert and scale, the scale, mix (a
    textured amount) and direction-mix classes, textured reflectance,
    roughness (u and v apart), displacement and mix amounts, and a rotated
    image environment light from a PNG, against the reference loader's
    tables; then a small render on the CPU."""
    from shimmer_tpu_torch.render import render

    ensure_reference_sah()
    _write_texture_files(tmp_path)
    jb, b = both(TEXTURED_SCENE, search_dir=tmp_path)
    job = b.create(device="cpu")
    assert_scene_tables_equal(job.scene, jb.create().scene)
    assert job.scene.has_bump_maps and not job.scene.has_normal_maps
    assert job.scene.materials.textured_params == ("reflectance", "uroughness", "vroughness")
    img, _ = render(job.scene, job.camera, job.film, job.sampler, spp=job.spp,
                    max_depth=job.max_depth)
    assert np.isfinite(img.numpy()).all() and float(img.mean()) > 0.0


@pytest.mark.parametrize(
    "world, error",
    [
        ('Texture "t" "float" "imagemap" "string filename" "rough.pfm" "float maxanisotropy" [8]',
         "maxanisotropy"),
        ('Texture "t" "float" "checkerboard"', "unknown texture class"),
        ('Material "diffuse" "texture normalmap" "t"', "normalmap"),
        ('AreaLightSource "diffuse" "string filename" "sky.png"', "image area light"),
    ],
    ids=["unread_texture_parameter", "unknown_class", "normalmap", "image_area_light"],
)
def test_texture_refusals(tmp_path, world, error):
    """What the port still refuses around textures: a texture parameter
    nothing reads, a texture class the reference does not know either,
    normal maps from a file and image area lights (the reference reads
    neither)."""
    _write_texture_files(tmp_path)
    b = SceneBuilder(search_dir=tmp_path)
    with pytest.raises((NotImplementedError, ValueError), match=error):
        parse_str(_BASE % ("", world), b, search_dir=tmp_path)
        b.create(device="cpu")


# --- the golden scenes' tables ---


def assert_scene_tables_equal(scene, jscene):
    """Every table of the port's scene equals the reference's (textures and
    the env light's nested tables included)."""
    arrays, census = jax_scene_to_numpy(jscene)
    for key in ("has_spheres", "has_triangles", "has_patches", "has_instanced",
                "has_normal_maps", "has_bump_maps"):
        assert getattr(scene, key) == census[key], key
    for key in ("camera_medium", "has_interface_media"):
        assert getattr(scene, key) == census[key], key
    if scene.triangles is not None:
        assert scene.triangles.has_iface_media == census["triangles.has_iface_media"]
    if scene.patches is not None:
        assert scene.patches.has_uv == census["patches.has_uv"]
    if scene.instanced is not None:
        for key in ("stack_depth", "has_normals", "has_uv"):
            assert getattr(scene.instanced, key) == census[f"instanced.{key}"], key
    assert (scene.media is None) == ("media.g" not in arrays)
    for key in ("material_kinds", "light_kinds", "n_lights", "uniform_infinite_indices",
                "image_infinite_indices"):
        assert tuple(np.atleast_1d(getattr(scene, key))) == tuple(np.atleast_1d(census[key])), key
    assert (scene.textures is None) == ("textures.kind" not in arrays)
    assert (scene.env is None) == ("env.coeffs" not in arrays)
    if scene.textures is not None:
        for key in ("kinds_present", "has_amount_tex"):
            assert (tuple(np.atleast_1d(getattr(scene.textures, key)))
                    == tuple(np.atleast_1d(census[f"textures.{key}"]))), key
    compared = 0
    for key, want in arrays.items():
        got = scene
        for part in key.split("."):
            got = getattr(got, part, None)
        if got is None:
            continue  # a reference-only column (lights.position, tiles8, ...)
        got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        if key.startswith(("triangles.", "instanced.", "patches.")) and got.dtype == np.float32:
            assert got.tobytes() == np.ascontiguousarray(want, got.dtype).tobytes(), key
        else:
            np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=key)
        compared += 1
    assert compared >= 20


@pytest.fixture(scope="module")
def golden_jobs():
    ensure_reference_sah()
    out = {}
    for name in GOLDEN:
        jb, b = JaxBuilder(search_dir=SCENES_DIR), SceneBuilder(search_dir=SCENES_DIR)
        jax_parse_file(str(SCENES_DIR / f"{name}.pbrt"), jb)
        parse_file(str(SCENES_DIR / f"{name}.pbrt"), b)
        out[name] = (b.create(device="cpu"), jb.create())
    return out


def _tensors(obj, prefix=""):
    import dataclasses

    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            yield prefix + f.name, v
        elif dataclasses.is_dataclass(v):
            yield from _tensors(v, prefix + f.name + ".")


@pytest.mark.parametrize("name", GOLDEN)
def test_golden_scene_has_no_64_bit_tensor(golden_jobs, name):
    """numpy's float64 and int64 never reach the device."""
    dtypes = {k: v.dtype for k, v in _tensors(golden_jobs[name][0].scene)}
    assert len(dtypes) > 30
    assert not {k: d for k, d in dtypes.items() if d in (torch.float64, torch.int64)}


@pytest.mark.parametrize("name", GOLDEN)
def test_golden_scene_tables_match_reference(golden_jobs, name):
    job, jjob = golden_jobs[name]
    assert job.scene.has_spheres and job.scene.has_triangles
    assert_scene_tables_equal(job.scene, jjob.scene)
    assert (job.spp, job.max_depth, job.integrator) == (jjob.spp, jjob.max_depth, jjob.integrator)
    assert job.film.resolution == jjob.film.resolution
    assert job.film.filter.radius == tuple(jjob.film.filter.radius)
    assert job.film.filter_integral == jjob.film.filter_integral
    np.testing.assert_array_equal(job.film.output_rgb_from_sensor_rgb,
                                  jjob.film.output_rgb_from_sensor_rgb)
    s, js = job.sampler, jjob.sampler
    assert (s.samples_per_pixel, s.seed, s.log2_spp, s.n_base4_digits) == (
        js.samples_per_pixel, js.seed, js.log2_spp, js.n_base4_digits)
    w, h = job.film.resolution
    rng = np.random.default_rng(3)
    p_film = (rng.random((256, 2)) * [w, h]).astype(np.float32)
    u = rng.random((256, 2)).astype(np.float32)
    ray = job.camera.generate_ray(torch.from_numpy(p_film), torch.from_numpy(u))
    jray = jjob.camera.generate_ray(jnp.asarray(p_film), jnp.asarray(u))
    np.testing.assert_allclose(ray.o.numpy(), np.asarray(jray.o), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ray.d.numpy(), np.asarray(jray.d), rtol=0, atol=1e-6)


# --- PLY ---


def _ply_vertices(n_quads=3):
    rng = np.random.default_rng(9)
    nv = 4 * n_quads + 3
    p = rng.normal(size=(nv, 3)).astype(np.float32)
    nrm = rng.normal(size=(nv, 3)).astype(np.float32)
    uv = rng.random((nv, 2)).astype(np.float32)
    faces = [list(range(4 * k, 4 * k + 4)) for k in range(n_quads)] + [[nv - 3, nv - 2, nv - 1]]
    return p, nrm, uv, faces


def _write_ply(path: Path, fmt: str):
    p, nrm, uv, faces = _ply_vertices()
    header = (f"ply\nformat {fmt} 1.0\ncomment seeded test mesh\nelement vertex {len(p)}\n"
              + "".join(f"property float {c}\n" for c in ("x", "y", "z", "nx", "ny", "nz", "u", "v"))
              + f"element face {len(faces)}\nproperty list uchar int vertex_indices\nend_header\n")
    verts = np.concatenate([p, nrm, uv], axis=1)
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if fmt == "ascii":
            for row in verts:
                f.write((" ".join(repr(float(x)) for x in row) + "\n").encode())
            for face in faces:
                f.write((" ".join(str(x) for x in [len(face), *face]) + "\n").encode())
        else:
            e = "<" if fmt == "binary_little_endian" else ">"
            f.write(verts.astype(e + "f4").tobytes())
            for face in faces:
                f.write(struct.pack(e + "B" + "i" * len(face), len(face), *face))


@pytest.mark.parametrize("fmt", ["ascii", "binary_little_endian", "binary_big_endian"])
def test_read_ply_matches_reference(tmp_path, fmt):
    path = tmp_path / f"mesh_{fmt}.ply"
    _write_ply(path, fmt)
    got, want = read_ply(path), jax_read_ply(path)
    p, nrm, uv, faces = _ply_vertices()
    # Three quads split in two and one triangle.
    assert got["indices"].shape == (7, 3) and got["indices"].dtype == np.int32
    np.testing.assert_array_equal(got["indices"][:2], [[0, 1, 2], [0, 2, 3]])
    for key in ("p", "indices", "n", "uv"):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_array_equal(got["p"], p)


# --- unported directives, parameters and options ---

_BASE = """
Film "rgb" "integer xresolution" [8] "integer yresolution" [8]
Sampler "zsobol" "integer pixelsamples" [1]
%s
WorldBegin
LightSource "infinite" "rgb L" [1 1 1]
%s
Shape "sphere"
"""
UNPORTED = {
    # The port refuses where the reference warns: a medium of another
    # type (read as homogeneous there) and the goniometric and projection
    # lights (skipped there).
    "uniformgrid_medium": ("", 'MakeNamedMedium "g" "string type" "uniformgrid"'),
    "goniometric_light": ("", 'LightSource "goniometric" "rgb I" [1 1 1]'),
    "projection_light": ("", 'LightSource "projection" "rgb I" [1 1 1]'),
    # Neither package reads an area light inside an object (the reference
    # drops it from the two-level BVH).
    "object_area_light": ("", 'ObjectBegin "o"\nAreaLightSource "diffuse"\n'
                              'Shape "trianglemesh" "integer indices" [0 1 2] '
                              '"point3 P" [0 0 0 1 0 0 0 1 0]\nObjectEnd'),
    "disk": ("", 'Shape "disk"'),
    "goniometric_area": ("", 'AreaLightSource "goniometric"'),
    "measured_material": ("", 'Material "measured"'),
    "diffusetransmission": ("", 'Material "diffusetransmission"'),
    "shape_alpha": ("", 'Shape "sphere" "float alpha" [0.5]'),
    "bdpt": ('Integrator "bdpt"', ""),
    "gbuffer_film": ('Film "gbuffer"', ""),
    "active_transform": ("ActiveTransform StartTime", ""),
    "transform_times": ("TransformTimes 0 2", ""),
}


@pytest.mark.parametrize("case", list(UNPORTED))
def test_unported_feature_raises(case):
    before, world = UNPORTED[case]
    b = SceneBuilder()
    with pytest.raises(NotImplementedError, match="not ported"):
        parse_str(_BASE % (before, world), b)
        b.create(device="cpu")


# The megakernel slice's lifted refusals: each loads a job equal to the
# reference loader's, over a scene with a triangle mesh (so rows8 is
# compared under each render space).
_JOB_BASE = """
%s
LookAt 0.4 1 -3  0 0.2 0  0 1 0
Film "rgb" "integer xresolution" [12] "integer yresolution" [10] %s
WorldBegin
LightSource "infinite" "rgb L" [1 1 1]
Material "diffuse" "rgb reflectance" [0.6 0.3 0.2]
Shape "sphere"
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point3 P" [-2 -1 -2  2 -1 -2  2 -1 2  -2 -1 2]
"""
LIFTED_JOBS = {
    # (before WorldBegin, extra Film parameters)
    "orthographic": ('Camera "orthographic"', ""),
    "orthographic_lens": ('Camera "orthographic" "float lensradius" [0.1] '
                          '"float focaldistance" [2] "float screenwindow" [-2 2 -1.5 1.5]', ""),
    "spherical": ('Camera "spherical"', ""),
    "spherical_equirect": ('Camera "spherical" "string mapping" "equirect"', ""),
    "lensradius": ('Camera "perspective" "float lensradius" [0.1] "float focaldistance" [2.5]',
                   ""),
    "screenwindow": ('Camera "perspective" "float screenwindow" [-1 1 -0.7 0.9]', ""),
    "shutter": ('Camera "perspective" "float shutteropen" [0.2] "float shutterclose" [0.6]', ""),
    "gaussian_filter": ('PixelFilter "gaussian" "float sigma" [0.4]', ""),
    "mitchell_filter": ('PixelFilter "mitchell" "float B" [0.5] "float C" [0.25]', ""),
    "sinc_filter": ('PixelFilter "sinc" "float tau" [2]', ""),
    "triangle_filter": ('PixelFilter "triangle" "float xradius" [1.5]', ""),
    "independent_sampler": ('Sampler "independent" "integer pixelsamples" [4]', ""),
    "stratified_sampler": ('Sampler "stratified" "integer pixelsamples" [9] "integer seed" [2]',
                           ""),
    "simplepath": ('Integrator "simplepath" "integer maxdepth" [3]', ""),
    "randomwalk": ('Integrator "randomwalk"', ""),
    "film_iso": ("", '"float iso" [400]'),
    "film_whitebalance": ("", '"float whitebalance" [4500]'),
    "rendercoordsys_world": ('Option "string rendercoordsys" "world"', ""),
    "rendercoordsys_camera": ('Option "string rendercoordsys" "camera"', ""),
    "disablepixeljitter": ('Option "bool disablepixeljitter" true', ""),
    "disablewavelengthjitter": ('Option "bool disablewavelengthjitter" true', ""),
    "color_space": ('ColorSpace "aces2065-1"', ""),
    "color_space_dci_p3": ('ColorSpace "dci-p3"', ""),
}


@pytest.mark.parametrize("case", list(LIFTED_JOBS))
def test_lifted_job_matches_the_reference(case):
    ensure_reference_sah()
    before, film = LIFTED_JOBS[case]
    jb, b = both(_JOB_BASE % (before, film))
    job, jjob = b.create(device="cpu"), jb.create()
    _assert_jobs_equal(job, jjob)
    assert job.scene.has_triangles


@pytest.mark.parametrize("before, film, error", [
    ('Camera "realistic"', "", "unknown camera"),
    ('Sampler "halton"', "", "unknown sampler"),
    ('PixelFilter "blackman"', "", "unknown filter"),
    ("", '"string sensor" "canon_eos_100d"', "unknown sensor"),
    ('ColorSpace "prophoto"', "", "unknown color space"),
    ('Option "string rendercoordsys" "screen"', "", "rendering coordinate system"),
])
def test_unknown_names_raise_as_the_reference(before, film, error):
    """Where the reference raises ValueError, so does the port."""
    ensure_reference_sah()
    for builder, parse, kw in ((SceneBuilder(), parse_str, {"device": "cpu"}),
                               (JaxBuilder(), jax_parse, {})):
        with pytest.raises(ValueError, match=error):
            parse(_JOB_BASE % (before, film), builder)
            builder.create(**kw)


# The media and delta-light cases that raised before their slice: each now
# loads, with every table equal to the reference loader's.
LIFTED = {
    "named_medium": ("", 'MakeNamedMedium "fog" "string type" "homogeneous"'),
    "medium_interface": ("", 'MediumInterface "" ""'),
    "interface_material": ("", 'Material "interface"'),
    "point_light": ("", 'LightSource "point" "rgb I" [1 1 1]'),
    "spot_light": ("", 'LightSource "spot" "rgb I" [1 1 1]'),
    "distant_light": ("", 'LightSource "distant" "rgb L" [1 1 1]'),
    # And the instancing slice's.
    "object_instance": ("", 'ObjectBegin "o"\nObjectEnd'),
    "bilinearmesh": ("", 'Shape "bilinearmesh" "integer indices" [0 1 2 3] '
                         '"point3 P" [0 0 0 1 0 0 0 1 0 1 1 0]'),
    "patch_area_light": ("", 'AttributeBegin\nAreaLightSource "diffuse" "rgb L" [4 4 4]\n'
                             'Shape "bilinearmesh" "integer indices" [0 1 2 3 1 4 3 5] '
                             '"point3 P" [0 0 0 1 0 0 0 1 0 1 1 0.2 2 0 0 2 1 0]\nAttributeEnd'),
    "instanced_plymesh": ("", 'ObjectBegin "o"\nMaterial "none"\nShape "plymesh" '
                              '"string filename" "quads.ply"\nObjectEnd\nRotate 30 0 1 0\n'
                              'ObjectInstance "o"\nTranslate 0 2 0\nObjectInstance "o"'),
}


@pytest.mark.parametrize("case", list(LIFTED))
def test_lifted_feature_loads_as_the_reference(case, tmp_path):
    ensure_reference_sah()
    before, world = LIFTED[case]
    _write_ply(tmp_path / "quads.ply", "binary_little_endian")
    jb, b = both(_BASE % (before, world), search_dir=tmp_path)
    scene = b.create(device="cpu").scene
    assert_scene_tables_equal(scene, jb.create().scene)
    if case == "interface_material":
        assert int(scene.spheres.material_id[0]) == -1
    if case.endswith("_light"):
        assert len(scene.light_kinds) == 2
    if case == "patch_area_light":
        np.testing.assert_array_equal(scene.lights.shape_kind.numpy()[:2], [2, 2])
        np.testing.assert_array_equal(scene.patches.area_light_id.numpy(), [0, 1])
    if case == "instanced_plymesh":
        # Material "none" reads as material 0 inside an object, as in the
        # reference.
        assert scene.has_instanced and (scene.instanced.attr_rows[:, 15] == 0).all()


def test_bilinearmesh_without_indices_takes_the_vertices_in_order():
    """A standing difference: without "indices" the port takes the
    vertices four by four; the reference means to, but its test for a
    missing array never fires (its getter returns an empty one), so it
    loads no patch."""
    ensure_reference_sah()
    text = _BASE % ("", 'Shape "bilinearmesh" "point3 P" [0 0 0 1 0 0 0 1 0 1 1 0]')
    jb, b = both(text)
    scene = b.create(device="cpu").scene
    assert not jb.create().scene.has_patches
    assert scene.has_patches
    np.testing.assert_array_equal(scene.patches.p11.numpy(), [[1, 1, 0]])


# The texture and image-light cases that raised before the texture slice,
# with what they give now: tables equal to the reference loader's, or the
# error both loaders raise.
TEXTURE_CASES = {
    "texture": ("", 'Texture "t" "float" "constant" "float value" [0.5]', None),
    # "t" names no texture: both loaders read the parameter as a spectrum.
    "textured_param": ("", 'Material "diffuse" "texture reflectance" "t"',
                       (ParameterError, "not a spectrum")),
    # EXR needs imageio, which neither machine has; the port says so.
    "image_infinite": ("", 'LightSource "infinite" "string filename" "sky.exr"',
                       (NotImplementedError, "imageio")),
}


@pytest.mark.parametrize("case", list(TEXTURE_CASES))
def test_texture_feature_cases(case):
    ensure_reference_sah()
    before, world, error = TEXTURE_CASES[case]
    text = _BASE % (before, world)
    if error is not None:
        b = SceneBuilder()
        with pytest.raises(error[0], match=error[1]):
            parse_str(text, b)
            b.create(device="cpu")
        if error[0] is ParameterError:
            with pytest.raises(Exception, match=error[1]):
                jb = JaxBuilder()
                jax_parse(text, jb)
                jb.create()
        return
    jb, b = both(text)
    assert_scene_tables_equal(b.create(device="cpu").scene, jb.create().scene)


def test_base_scene_of_the_raise_cases_creates():
    b = SceneBuilder()
    parse_str(_BASE % ("", ""), b)
    job = b.create(device="cpu")
    assert job.scene.has_spheres and not job.scene.has_triangles


FEATURES_SCENE = """
LookAt 0.5 1 -4  0 0.2 0  0 1 0
Camera "perspective" "float fov" [38] "float shutteropen" [0] "float shutterclose" [1]
Film "rgb" "integer xresolution" [20] "integer yresolution" [14] "string filename" "f.pfm"
    "float maxcomponentvalue" [20]
Sampler "zsobol" "integer pixelsamples" [4] "integer seed" [3]
Integrator "volpath" "integer maxdepth" [7] "string lightsampler" "bvh"
PixelFilter "box" "float xradius" [0.5] "float yradius" [0.5]
Accelerator "bvh"
WorldBegin
CoordinateSystem "origin"
LightSource "infinite" "blackbody L" [5500] "float scale" [0.4]
MakeNamedMaterial "paint" "string type" "coateddiffuse" "rgb reflectance" [0.3 0.5 0.2]
    "float roughness" [0.1] "float thickness" [0.02] "rgb albedo" [0.1 0.1 0.1] "float g" [0.2]
MakeNamedMaterial "copper" "string type" "coatedconductor" "float interface.roughness" [0.05]
    "float conductor.roughness" [0.2] "spectrum conductor.eta" "metal-Cu-eta"
    "spectrum conductor.k" "metal-Cu-k"
MakeNamedMaterial "thin" "string type" "thindielectric" "float eta" [1.4]
MakeNamedMaterial "glass" "string type" "dielectric" "spectrum eta" "glass-BK7"
    "bool remaproughness" false "float uroughness" [0.2] "float vroughness" [0.1]
MakeNamedMaterial "blend" "string type" "mix" "string materials" ["paint" "copper"]
    "float amount" [0.3]
NamedMaterial "paint"
Shape "plymesh" "string filename" "quads.ply"
AttributeBegin
  ReverseOrientation
  NamedMaterial "copper"
  Translate 0 0.1 0
  Rotate 30 0 1 0
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
      "point3 P" [-2 0 -2  2 0 -2  2 0 2  -2 0 2]
      "normal N" [0 1 0  0 1 0  0 1 0  0 1 0] "point2 uv" [0 0 1 0 1 1 0 1]
AttributeEnd
AttributeBegin
  NamedMaterial "blend"
  ConcatTransform [1 0 0 0  0 1.2 0 0  0 0 1 0  0.4 0.5 0.3 1]
  Attribute "shape" "float radius" [0.35]
  Shape "sphere" "float zmin" [-0.2] "float phimax" [290]
  NamedMaterial "glass"
  Translate -0.9 0 0
  Shape "sphere"
AttributeEnd
AttributeBegin
  CoordSysTransform "origin"
  NamedMaterial "thin"
  Translate 0 2 0
  AreaLightSource "diffuse" "rgb L" [6 5 4] "bool twosided" true "float scale" [2]
  Shape "sphere" "float radius" [0.2]
  Shape "trianglemesh" "integer indices" [0 1 2] "point3 P" [-0.3 0.3 0  0.3 0.3 0  0 0.6 0]
AttributeEnd
"""


def test_feature_scene_tables_match_reference(tmp_path):
    """One scene of every ported feature: a binary PLY with normals, uvs
    and quads; ReverseOrientation, Rotate, ConcatTransform, named
    coordinate systems, a scoped Attribute; every ported material kind
    (named, a spectral and a non-remapped rough dielectric, a coated
    conductor, a mix); a two-sided area light on a sphere and on a
    triangle; a blackbody infinite light; the power light sampler; the
    film, filter, camera and sampler parameters; volpath as path."""
    ensure_reference_sah()
    _write_ply(tmp_path / "quads.ply", "binary_little_endian")
    jb, b = both(FEATURES_SCENE, search_dir=tmp_path)
    job, jjob = b.create(device="cpu"), jb.create()
    assert set(job.scene.material_kinds) == {0, 1, 2, 3, 4, 5, 6} - {1}
    assert job.light_sampler == "power" and job.integrator == "path" and job.max_depth == 7
    assert (job.spp, job.sampler.seed, job.filename) == (4, 3, "f.pfm")
    assert job.film.max_component_value == jjob.film.max_component_value == 20.0
    assert_scene_tables_equal(job.scene, jjob.scene)
    np.testing.assert_array_equal(job.scene.light_sample_weights.numpy(),
                                  np.asarray(jjob.scene.light_sample_weights))
