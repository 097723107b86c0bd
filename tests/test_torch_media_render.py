"""Media and delta lights as a whole: the port's wavefront against the
reference's on the CPU, at 24x16 pixels and 4 spp, on three scenes read by
each package's loader:

- ``fog``: an exterior fog (the camera medium) lit by a point light, over
  a floor with a diffuse and a glass sphere, depth 5;
- ``interface``: tests/test_media.py's interface scene (an ink slab between
  two material-less quads under an emissive quad, depth 5), with the
  zsobol sampler in place of the independent one, which the port lacks;
- ``delta``: point, spot and distant lights and no media, with 36
  materials (beyond the reference's 32-row clamped gather) and one
  material-less quad, which both packages shade with the material table's
  last row; depth 4.

Criteria: equal traced rays and loop iterations; at most 1% of pixels
beyond rtol 1e-3 / atol 1e-4, and image means within 1e-3 relative
(tests/test_torch_wavefront.py's ``assert_images_agree``).  Each case
prints its count of differing pixels: 0 of 384 for all three when this
test was written.  The port's tables equal the reference's
(tests/test_torch_media.py and test_torch_delta_lights.py hold the loader
to that byte for byte); here the census is checked.
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
_HEAD = f"""
LookAt 0 1.2 -4.5  0 0.4 0  0 1 0
Camera "perspective" "float fov" [45]
Film "rgb" "integer xresolution" [{RES[0]}] "integer yresolution" [{RES[1]}]
Sampler "zsobol" "integer pixelsamples" [{SPP}]
"""

FOG = """
MakeNamedMedium "fog" "string type" "homogeneous"
    "rgb sigma_a" [0.03 0.04 0.05] "rgb sigma_s" [0.15 0.15 0.12] "float g" [0.3]
MediumInterface "" "fog"
""" + _HEAD + """
Integrator "volpath" "integer maxdepth" [5]
WorldBegin
MediumInterface "" ""
LightSource "point" "point3 from" [0.8 2.5 -1.2] "rgb I" [6 5.5 5]
Material "diffuse" "rgb reflectance" [0.5 0.5 0.45]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point3 P" [-5 0 -5  5 0 -5  5 0 5  -5 0 5]
AttributeBegin
  Material "diffuse" "rgb reflectance" [0.2 0.4 0.7]
  Translate -0.7 0.5 0
  Shape "sphere" "float radius" [0.5]
AttributeEnd
AttributeBegin
  Material "dielectric" "float eta" [1.5]
  Translate 0.8 0.45 0.3
  Shape "sphere" "float radius" [0.45]
AttributeEnd
"""

# tests/test_media.py::TestInterfaceMedia::test_wavefront_matches_megakernel_interfaces
INTERFACE = """
MakeNamedMedium "ink" "string type" "homogeneous"
  "rgb sigma_a" [0.4 0.2 0.1] "rgb sigma_s" [0.2 0.2 0.2]
LookAt 0 0 -4  0 0 0  0 1 0
Camera "perspective" "float fov" [40]
Film "rgb" "integer xresolution" [24] "integer yresolution" [16]
Sampler "zsobol" "integer pixelsamples" [4]
Integrator "volpath" "integer maxdepth" [5]
WorldBegin
Material "diffuse" "rgb reflectance" [0.3 0.3 0.3]
AttributeBegin
MediumInterface "ink" ""
Material "none"
Shape "trianglemesh"
  "point3 P" [-3 -3 0.5  -3 3 0.5  3 3 0.5  3 -3 0.5]
  "integer indices" [0 1 2 0 2 3]
Shape "trianglemesh"
  "point3 P" [-3 -3 1.5  3 -3 1.5  3 3 1.5  -3 3 1.5]
  "integer indices" [0 1 2 0 2 3]
AttributeEnd
AttributeBegin
AreaLightSource "diffuse" "float scale" [8]
Shape "trianglemesh"
  "point3 P" [-6 -6 3  -6 6 3  6 6 3  6 -6 3]
  "integer indices" [0 1 2 0 2 3]
AttributeEnd
"""


def _delta_scene() -> str:
    """A floor of 34 tiles, each with a material of its own (36 rows with
    the loader's default material and the glass sphere's, which is last),
    a material-less quad in front, and a point, a spot and a distant
    light."""
    rng = np.random.default_rng(13)
    tiles = []
    for k in range(34):
        x0, z0 = -3.5 + (k % 7), -1.5 + (k // 7)
        r, g, b = rng.uniform(0.1, 0.9, 3)
        mat = (f'Material "conductor" "float roughness" [{0.05 + 0.02 * k:.3f}]'
               if k % 5 == 4 else f'Material "diffuse" "rgb reflectance" [{r:.3f} {g:.3f} {b:.3f}]')
        tiles.append(f"""{mat}
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point3 P" [{x0} 0 {z0}  {x0 + 1} 0 {z0}  {x0 + 1} 0 {z0 + 1}  {x0} 0 {z0 + 1}]""")
    return _HEAD + """
Integrator "path" "integer maxdepth" [4] "string lightsampler" "power"
WorldBegin
LightSource "point" "point3 from" [-1 2 -1] "rgb I" [3 3 3]
LightSource "spot" "point3 from" [1.5 3 -1.5] "point3 to" [0.5 0 0.5] "blackbody I" [3000]
    "float coneangle" [25] "float conedeltaangle" [5] "float scale" [6]
LightSource "distant" "point3 from" [0 1 0] "point3 to" [0.4 0 0.3] "rgb L" [0.8 0.8 0.9]
""" + "\n".join(tiles) + """
AttributeBegin
  Material "interface"
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
      "point3 P" [-0.8 0.2 -1.6  0.8 0.2 -1.6  0.8 1.4 -1.6  -0.8 1.4 -1.6]
AttributeEnd
Material "dielectric" "float eta" [1.6]
Translate 0 0.5 0.8
Shape "sphere" "float radius" [0.5]
"""


SCENES = {"fog": FOG, "interface": INTERFACE, "delta": _delta_scene()}


@pytest.mark.parametrize("case", list(SCENES))
def test_media_render_matches_reference(case):
    ensure_reference_sah()
    text = SCENES[case]
    jb, b = JaxBuilder(), SceneBuilder()
    jax_parse(text, jb)
    parse_str(text, b)
    jjob, job = jb.create(), b.create(device="cpu")
    scene = job.scene
    census = {"fog": (0, False, True), "interface": (-1, True, True),
              "delta": (-1, False, False)}[case]
    assert (scene.camera_medium, scene.has_interface_media, scene.media is not None) == census
    assert (jjob.scene.camera_medium, jjob.scene.has_interface_media) == census[:2]
    if case == "delta":
        assert scene.light_kinds == (0, 1, 2) and len(scene.materials.kind) == 36
        assert (scene.triangles.attr_rows[:, 15] == -1).any()
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
