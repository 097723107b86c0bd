"""The masked megakernel (``render(..., wavefront=False)``, ``li_path``) and
the other estimators on the card:

* at 64x48, 4 spp through the loader, the card against the CPU, each with
  its exact v1 launch count: the loaded bench scene under the megakernel,
  "simplepath" and "randomwalk", the interface-media scene under the
  megakernel, and four feature scenes holding the independent and
  stratified samplers, the gaussian, mitchell, sinc and triangle
  filters, the orthographic and spherical (both mappings) cameras, a thin
  lens with a screen window, the camera and world render spaces, both
  jitter options, ColorSpace rec2020 and the film's ISO and white balance;
* the bench scene in several pixel blocks through the megakernel: exactly
  n_blocks x spp x (1 + depth) v1 launches, and the image against a
  wavefront render of the same samples.

Marked ``card``; run on the card as tests/card_checks.py says.
"""

import dataclasses

import pytest

import card_scenes as cs
from card_checks import (  # noqa: F401  (card: a fixture)
    BLOCK,
    CONFIGS,
    MAX_DEPTH,
    SMALL_RES,
    SMALL_SPP,
    assert_images_agree,
    card,
    launches,
    reset_launches,
)
from shimmer_tpu_torch.bench_scene import (
    BENCH_TRIS,
    build_bench_scene,
    make_displaced_sphere,
)
from shimmer_tpu_torch.loading.parser import parse_file
from shimmer_tpu_torch.loading.scene_builder import SceneBuilder
from shimmer_tpu_torch.render import render
from shimmer_tpu_torch.samplers import ZSobolSampler

pytestmark = pytest.mark.card

# Scene file -> (its text, whether the megakernel is forced).
CASES = {
    "loaded_megakernel": (cs.loaded_scene_text(SMALL_RES, SMALL_SPP), True),
    "loaded_simplepath": (cs.loaded_scene_text(SMALL_RES, SMALL_SPP)
                          .replace('Integrator "path"', 'Integrator "simplepath"'), False),
    "loaded_randomwalk": (cs.loaded_scene_text(SMALL_RES, SMALL_SPP)
                          .replace('Integrator "path"', 'Integrator "randomwalk"'), False),
    "interface_media_megakernel": (cs.media_scene_text(SMALL_RES, SMALL_SPP, "interface"), True),
    **{case: (cs.feature_scene_text(case), False) for case in cs.FEATURE_SCENES},
}
# The bench scene's blocks through the megakernel: 64x48 pixels in blocks
# of 1,024.
BLOCK_PIXELS = 1024


def megakernel_launches(integrator: str, max_depth: int, interface_media: bool) -> int:
    """v1 launches of one estimator call on a scene with triangles: path
    traces the camera rays, then one merged trace a bounce (and three
    shadow-march rounds with interface media); simplepath a closest-hit
    trace a depth and a shadow trace a bounce; randomwalk a trace a
    depth."""
    if integrator == "path":
        return 1 + max_depth * (4 if interface_media else 1)
    if integrator == "simplepath":
        return 2 * max_depth + 1
    return max_depth + 1


def load_job(path):
    """A scene file through the port's loader on the CPU, under v1."""
    builder = SceneBuilder(search_dir=path.parent)
    parse_file(str(path), builder)
    return builder.create(device="cpu", traverse=CONFIGS["v1"])


def render_case(job, scene, megakernel: bool):
    """A case at its in-file settings: the megakernel when forced, else the
    dispatch of its integrator."""
    return render(scene, job.camera, job.film, job.sampler, integrator=job.integrator,
                  spp=job.spp, max_depth=job.max_depth, wave_spp=SMALL_SPP, pixel_block=BLOCK,
                  wavefront=False if megakernel else None, collect_stats=True,
                  disable_pixel_jitter=job.disable_pixel_jitter,
                  disable_wavelength_jitter=job.disable_wavelength_jitter)


@pytest.fixture(scope="module")
def scene_dir(card, tmp_path_factory):
    d = tmp_path_factory.mktemp("scenes")
    cs.write_ply(d / cs.LOADED_PLY, *make_displaced_sphere(BENCH_TRIS))
    return d


@pytest.mark.parametrize("name", list(CASES))
def test_estimator_on_the_card_agrees_with_the_cpu(card, scene_dir, name):
    text, megakernel = CASES[name]
    path = scene_dir / f"{name}.pbrt"
    path.write_text(text)
    job = load_job(path)
    scene = job.scene.to(card)
    reset_launches()
    img, _, stats = render_case(job, scene, megakernel)
    n = launches("v1")
    if megakernel or job.integrator != "path":
        want = job.spp * megakernel_launches(job.integrator, job.max_depth,
                                             scene.has_interface_media)
    else:
        want = int(stats["iters"])
    assert n == want
    assert_images_agree(img, render_case(job, job.scene, megakernel)[0])


def test_megakernel_launches_a_trace_a_bounce_per_block(card):
    scene, cam, film = build_bench_scene(BENCH_TRIS, SMALL_RES, device="cpu")
    scene = scene.to(card)
    scene = dataclasses.replace(scene, triangles=scene.triangles.with_traverse(CONFIGS["v1"]))
    n_blocks = -(-SMALL_RES[0] * SMALL_RES[1] // BLOCK_PIXELS)
    assert n_blocks > 1
    images = {}
    for wavefront in (False, True):
        reset_launches()
        images[wavefront], _ = render(scene, cam, film, ZSobolSampler(SMALL_SPP, SMALL_RES),
                                      spp=SMALL_SPP, max_depth=MAX_DEPTH, wave_spp=SMALL_SPP,
                                      pixel_block=BLOCK_PIXELS, wavefront=wavefront)
        n = launches("v1")
        if not wavefront:
            assert n == n_blocks * SMALL_SPP * (1 + MAX_DEPTH)
    assert_images_agree(images[False], images[True])
