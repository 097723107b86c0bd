"""The wavefront render on the card against the same render on the CPU,
at 64x48 and 4 spp, depth 5, one 2^17-lane pool:

* the bench scene (327,684 triangles) under each traversal configuration
  (v1, v2, v1 with MT leaves, v1 with the min-id winner), each card image
  against the CPU's image of the same leaf test and winner rule (the CPU
  runs the plain traversal, which v1 and v2 share);
* the material bench scene (a mix of rough gold and dispersive glass on
  the sphere, a coated diffuse floor) under v1;
* the bench scene at the diffuse cell's render settings (1280x720, 16
  spp in 4-spp waves over one 921,600-lane pool, depth 5) under the
  scene's own traversal configuration: exactly one launch of its kernel
  an iteration, so no size sends a batch to another kernel or to the
  plain traversal.

Each card render launches its configuration's kernel and no other, and
ZSobol's kernels.  Marked ``card``; run on the card as
tests/card_checks.py says.
"""

import dataclasses

import numpy as np
import pytest

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
    BENCH_RESOLUTION,
    BENCH_TRIS,
    bench_camera_film,
    build_bench_scene,
    build_material_bench_scene,
)
from shimmer_tpu_torch.ops import sampler as zk
from shimmer_tpu_torch.render import render
from shimmer_tpu_torch.samplers import ZSobolSampler

pytestmark = pytest.mark.card


def small_render(scene, config: str):
    cam, film = bench_camera_film(SMALL_RES)
    scene = dataclasses.replace(scene, triangles=scene.triangles.with_traverse(CONFIGS[config]))
    return render(scene, cam, film, ZSobolSampler(SMALL_SPP, SMALL_RES), spp=SMALL_SPP,
                  max_depth=MAX_DEPTH, wave_spp=SMALL_SPP, pixel_block=BLOCK)[0]


class CardAndCpu:
    """A scene on the CPU and on the card, and its CPU images, once per
    (leaf test, winner rule)."""

    def __init__(self, scene_cpu, dev):
        self.cpu, self.card = scene_cpu, scene_cpu.to(dev)
        self._images = {}

    def cpu_image(self, config: str):
        cfg = CONFIGS[config]
        key = (cfg.leaf, cfg.winner)
        if key not in self._images:
            self._images[key] = small_render(self.cpu, config)
        return self._images[key]

    def assert_card_agrees(self, config: str):
        reset_launches()
        img = small_render(self.card, config)
        launches(config)
        assert min(zk.launch_counts().values()) > 0, "ZSobol ran without its kernels"
        assert_images_agree(img, self.cpu_image(config))


@pytest.fixture(scope="module")
def bench(card):
    return CardAndCpu(build_bench_scene(BENCH_TRIS, BENCH_RESOLUTION, device="cpu")[0], card)


@pytest.fixture(scope="module")
def materials(card):
    return CardAndCpu(build_material_bench_scene(BENCH_TRIS, BENCH_RESOLUTION, device="cpu")[0],
                      card)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_bench_render_on_the_card_agrees_with_the_cpu(bench, config):
    bench.assert_card_agrees(config)


def test_material_render_on_the_card_agrees_with_the_cpu(materials):
    materials.assert_card_agrees("v1")


# The diffuse cell's frames: spp, wave and pixel block.
CELL_SPP, CELL_WAVE_SPP, CELL_BLOCK = 16, 4, 1 << 20


def test_bench_render_at_the_cell_size_launches_one_traversal_an_iteration(bench):
    cam, film = bench_camera_film(BENCH_RESOLUTION)
    reset_launches()
    img, _, stats = render(bench.card, cam, film, ZSobolSampler(CELL_SPP, BENCH_RESOLUTION),
                           spp=CELL_SPP, max_depth=MAX_DEPTH, wave_spp=CELL_WAVE_SPP,
                           pixel_block=CELL_BLOCK, collect_stats=True)
    assert launches(bench.card.triangles.traverse.name) == int(stats["iters"])
    assert min(zk.launch_counts().values()) > 0, "ZSobol ran without its kernels"
    img = img.cpu().numpy()
    assert img.shape == (BENCH_RESOLUTION[1], BENCH_RESOLUTION[0], 3)
    assert np.isfinite(img).all() and img.mean() > 0
