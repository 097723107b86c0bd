"""In-process row bands over several cards (``parallel.render.render_sharded``
over ``make_tile_mesh()``, what ``cli.py --shard`` runs without
``torchrun``): each band renders with its card the current device, so its
hand-written kernels (traversal, ZSobol) launch there, and the image is
the same bands' image rendered on one card.

Marked ``card``: it skips without two CUDA cards.  tests/conftest.py
imports JAX, which the card's machine lacks, so run it there with

    python3 -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_sharded_card.py
"""

import pytest
import torch

from shimmer_tpu_torch.bench_scene import build_bench_scene
from shimmer_tpu_torch.parallel.render import make_tile_mesh, render_sharded
from shimmer_tpu_torch.samplers import ZSobolSampler

pytestmark = pytest.mark.card

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
