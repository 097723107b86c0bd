"""Bilinear patches and instancing as a whole: the port's wavefront against
the reference's on the CPU, at 24x16 pixels and 4 spp, on three scenes
read by each package's loader:

- ``instances``: four instances of a small triangle object (turned and
  scaled) beside a world floor and a world quad light, no sphere, so the
  merged trace must leave its world-triangle fast path for the union;
- ``patches``: a planar patch floor, a twisted patch wall with uvs under a
  conductor and a patch quad light, lit under the power light sampler;
- ``both``: the two together, with world triangles, instances, patches
  and a patch light in one union, and an object whose sphere is copied
  per instance.

Criteria: equal traced rays and loop iterations; at most 1% of pixels
beyond rtol 1e-3 / atol 1e-4, and image means within 1e-3 relative
(tests/test_torch_wavefront.py's ``assert_images_agree``).  Each case
prints its count of differing pixels.  The tables are held to the
reference loader's byte for byte in tests/test_torch_loader.py; here the
census is checked.
"""

import os

os.environ.setdefault("OMP_NUM_THREADS", "1")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shimmer_tpu.loading.parser import parse_str as jax_parse
from shimmer_tpu.loading.scene_builder import SceneBuilder as JaxBuilder
from shimmer_tpu.render import make_wavefront_renderer as jax_wavefront
from shimmer_tpu.render import pixel_blocks as jax_blocks
from shimmer_tpu_torch.loading.parser import parse_str
from shimmer_tpu_torch.loading.scene_builder import SceneBuilder
from shimmer_tpu_torch.render import make_wavefront_renderer as torch_wavefront
from shimmer_tpu_torch.render import pixel_blocks as torch_blocks
from test_torch_wavefront import assert_images_agree
from torch_parity import ensure_reference_sah

torch.set_num_threads(1)

RES = (24, 16)
SPP = 4


def _head(sampler: str = "") -> str:
    return f"""
LookAt 0 1.6 -5  0 0.4 0  0 1 0
Camera "perspective" "float fov" [45]
Film "rgb" "integer xresolution" [{RES[0]}] "integer yresolution" [{RES[1]}]
Sampler "zsobol" "integer pixelsamples" [{SPP}]
Integrator "path" "integer maxdepth" [4] {sampler}
WorldBegin
LightSource "infinite" "rgb L" [0.15 0.15 0.2]
"""


INSTANCES = """
ObjectBegin "rock"
  Material "diffuse" "rgb reflectance" [0.6 0.4 0.3]
  Shape "trianglemesh" "integer indices" [0 1 2  0 2 3  0 3 1  1 3 2]
      "point3 P" [0 0.8 0  -0.5 0 -0.4  0.5 0 -0.4  0 0 0.55]
ObjectEnd
AttributeBegin
  Translate -1.4 0 0.3
  ObjectInstance "rock"
  Translate 1.2 0 0.6
  Rotate 40 0 1 0
  Scale 0.7 1.2 0.7
  ObjectInstance "rock"
AttributeEnd
AttributeBegin
  Translate 1.3 0 -0.2
  Rotate -70 0 1 0
  ObjectInstance "rock"
  Translate 0.4 0 1.5
  Scale 1.5 0.6 1.5
  ObjectInstance "rock"
AttributeEnd
"""

WORLD = """
Material "diffuse" "rgb reflectance" [0.45 0.45 0.45]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point3 P" [-5 0 -5  5 0 -5  5 0 5  -5 0 5]
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [6 6 6]
  Material "diffuse" "rgb reflectance" [0 0 0]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
      "point3 P" [-0.6 3 -0.6  0.6 3 -0.6  0.6 3 0.6  -0.6 3 0.6]
AttributeEnd
"""

PEBBLES = """
ObjectBegin "pebble"
  Material "dielectric" "float eta" [1.5]
  Shape "trianglemesh" "integer indices" [0 1 2]
      "point3 P" [-0.2 0 0  0.2 0 0  0 0.3 0.1]
  AttributeBegin
    Translate 0 0.45 0
    Shape "sphere" "float radius" [0.15]
  AttributeEnd
ObjectEnd
AttributeBegin
  Translate -0.4 0 -1.2
  ObjectInstance "pebble"
  Translate 0.9 0 0.2
  Rotate 30 0 1 0
  ObjectInstance "pebble"
AttributeEnd
"""

PATCHES = """
Material "diffuse" "rgb reflectance" [0.5 0.5 0.45]
Shape "bilinearmesh" "integer indices" [0 1 2 3]
    "point3 P" [-5 -0.01 -5  5 -0.01 -5  -5 -0.01 5  5 -0.01 5]
AttributeBegin
  Material "conductor" "spectrum eta" "metal-Cu-eta" "spectrum k" "metal-Cu-k"
      "float roughness" [0.15]
  Shape "bilinearmesh" "integer indices" [0 1 3 4  1 2 4 5]
      "point3 P" [-2 0 2  0 0 2.4  2 0 2  -2 2 2.5  0 2 1.8  2 2 2.6]
      "point2 uv" [0 0  0.5 0  1 0  0 1  0.5 1  1 1]
AttributeEnd
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [8 7 6]
  Material "diffuse" "rgb reflectance" [0 0 0]
  Shape "bilinearmesh" "integer indices" [0 1 2 3]
      "point3 P" [-0.5 2.6 -0.5  0.5 2.6 -0.5  -0.5 2.6 0.5  0.5 2.6 0.5]
AttributeEnd
"""

SCENES = {
    "instances": _head() + WORLD + INSTANCES,
    "patches": _head('"string lightsampler" "power"') + PATCHES,
    "both": _head('"string lightsampler" "power"') + WORLD + PATCHES + INSTANCES + PEBBLES,
}
# (has_triangles, has_patches, has_instanced, has_spheres) of each scene.
CENSUS = {"instances": (True, False, True, False), "patches": (False, True, False, False),
          "both": (True, True, True, True)}


@pytest.mark.parametrize("case", list(SCENES))
def test_instanced_render_matches_reference(case):
    ensure_reference_sah()
    text = SCENES[case]
    jb, b = JaxBuilder(), SceneBuilder()
    jax_parse(text, jb)
    parse_str(text, b)
    jjob, job = jb.create(), b.create(device="cpu")
    scene = job.scene
    census = (scene.has_triangles, scene.has_patches, scene.has_instanced, scene.has_spheres)
    assert census == CENSUS[case]
    assert census == (jjob.scene.has_triangles, jjob.scene.has_patches, jjob.scene.has_instanced,
                      jjob.scene.has_spheres)
    if scene.has_patches:
        assert int((scene.lights.shape_kind == 2).sum()) == 1
    depth = job.max_depth
    wave = jax_wavefront(jjob.scene, jjob.camera, jjob.film, jjob.sampler, max_depth=depth,
                         with_stats=True)
    blocks, valids = jax_blocks(jjob.film, RES[0] * RES[1])
    jstate, jstats = wave(jjob.film.init_state(), jnp.arange(SPP, dtype=jnp.uint32), blocks[0],
                          valids[0])
    ref = np.asarray(jjob.film.get_image(jstate))
    twave = torch_wavefront(scene, job.camera, job.film, job.sampler, max_depth=depth)
    tblocks, tvalids = torch_blocks(job.film, RES[0] * RES[1], device="cpu")
    state, stats = twave(job.film.init_state("cpu"), torch.arange(SPP), tblocks[0], tvalids[0])
    img = job.film.get_image(state).numpy()
    differ = ~np.isclose(img, ref, rtol=1e-3, atol=1e-4).all(axis=-1)
    print(f"{case}: {int(differ.sum())} of {differ.size} pixels beyond rtol 1e-3 / atol 1e-4; "
          f"rays {float(stats['rays'])} vs {float(jstats['rays'])}, iterations "
          f"{float(stats['iters'])} vs {float(jstats['iters'])}")
    assert float(stats["rays"]) == float(jstats["rays"])
    assert float(stats["iters"]) == float(jstats["iters"])
    assert_images_agree(img, ref)
