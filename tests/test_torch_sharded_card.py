"""Row bands (``parallel.render.render_sharded``) on the card:

* the bench at 1280x720, 4 spp, over two bands of one card in tiles mode
  and in spp mode, against the unsharded render of the same samples in
  2^17-pixel blocks (each band one 460,800-pixel pool, the second from
  row 360: a pixel's samples may not depend on where its block or band
  starts), with exactly the bands' iterations of v1 launches;
* the sharded training step (``flagship.dryrun_multichip``) on two bands
  of the card against the CPU;
* in-process bands over several cards (over ``make_tile_mesh()``, what
  ``cli.py --shard`` runs without ``torchrun``): each band renders with
  its card the current device, so its hand-written kernels (traversal,
  ZSobol) launch there, and the image is the same bands' image rendered
  on one card (skips without two cards).

Marked ``card``; run on the card as tests/card_checks.py says.
"""

import dataclasses

import numpy as np
import pytest
import torch

from card_checks import (  # noqa: F401  (card: a fixture)
    BLOCK,
    CONFIGS,
    MAX_DEPTH,
    card,
    launches,
    max_rel,
    reset_launches,
)
from shimmer_tpu_torch.bench_scene import BENCH_RESOLUTION, BENCH_TRIS, build_bench_scene
from shimmer_tpu_torch.flagship import dryrun_multichip
from shimmer_tpu_torch.parallel.render import make_tile_mesh, render_sharded
from shimmer_tpu_torch.render import render
from shimmer_tpu_torch.samplers import ZSobolSampler

pytestmark = pytest.mark.card

BANDS = 2
BANDS_SPP = 4
# Max relative difference from the unsharded image: tiles mode renders
# each pixel's samples as the unsharded render does; spp mode adds the
# bands' film states.
SHARD_RTOL = {"tiles": 1e-6, "spp": 1e-5}
# The sharded training step, card against CPU: the gradient's largest
# difference over its largest entry.
GRAD_RTOL = 1e-3

RES = (320, 180)
SPP = 4
SEED = 3_000_000_019


@pytest.fixture
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: this test runs on the chip")
    return torch.cuda.device_count()


def test_bands_on_several_cards_match_one_card(cards):
    torch.cuda.set_device(0)
    scene, cam, film = build_bench_scene(20_480, RES, torch.device("cuda", 0))
    kw = dict(spp=SPP, max_depth=5, wave_spp=2)
    bands = 4 if RES[1] % 4 == 0 and cards >= 4 else 2
    spread = make_tile_mesh([torch.device("cuda", i) for i in range(bands)])
    alone = make_tile_mesh([torch.device("cuda", 0)] * bands)
    got, _ = render_sharded(scene, cam, film, ZSobolSampler(SPP, RES, seed=SEED), spread, **kw)
    want, _ = render_sharded(scene, cam, film, ZSobolSampler(SPP, RES, seed=SEED), alone, **kw)
    assert got.device == want.device and float(want.mean()) > 0
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def bench(card):
    scene, cam, film = build_bench_scene(BENCH_TRIS, BENCH_RESOLUTION, device="cpu")
    scene = scene.to(card)
    scene = dataclasses.replace(scene, triangles=scene.triangles.with_traverse(CONFIGS["v1"]))
    img, _ = render(scene, cam, film, ZSobolSampler(BANDS_SPP, BENCH_RESOLUTION), spp=BANDS_SPP,
                    max_depth=MAX_DEPTH, wave_spp=BANDS_SPP, pixel_block=BLOCK)
    return scene, cam, film, img.cpu().numpy()


@pytest.mark.parametrize("mode", ["tiles", "spp"])
def test_bands_of_one_card_match_the_unsharded_render(card, bench, mode):
    scene, cam, film, whole = bench
    # tiles: one wave of every sample; spp: two waves, a sample a band each.
    wave_spp = BANDS_SPP if mode == "tiles" else BANDS_SPP // (2 * BANDS)
    reset_launches()
    img, _, st = render_sharded(scene, cam, film, ZSobolSampler(BANDS_SPP, BENCH_RESOLUTION),
                                make_tile_mesh([card] * BANDS), spp=BANDS_SPP,
                                max_depth=MAX_DEPTH, wave_spp=wave_spp, mode=mode,
                                collect_stats=True)
    assert launches("v1") == int(st["iters"])
    img = img.cpu().numpy()
    assert np.isfinite(img).all() and max_rel(img, whole) <= SHARD_RTOL[mode]


def test_sharded_training_step_on_the_card_matches_the_cpu(card):
    got = dryrun_multichip([card] * BANDS)["grad"].reshape(-1)
    want = dryrun_multichip(["cpu"] * BANDS)["grad"].reshape(-1)
    assert np.max(np.abs(got - want)) <= GRAD_RTOL * np.abs(want).max()
