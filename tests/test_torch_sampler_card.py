"""The ZSobol kernels (csrc/sampler.cu) on the card, against the torch code
they replace: ``samplers.ZSobolSampler`` runs it for CPU tensors, and these
tests run it on CUDA tensors by patching ``samplers._on_card``, which the
program never switches.

* every start and draw at the diffuse cell's sampler (1280x720, 16 spp,
  a seed above 2^31) over the frame's 921,600 lanes, ``torch.equal``;
* the launch counters against the ZSobol calls of a wavefront block-wave,
  each draw launched inside its ``sampler/draw`` span;
* the bench render (the frame one lane pool, one 4-spp wave) and a small
  megakernel render, each image ``torch.equal`` to the torch code's.

Marked ``card``: each skips without a CUDA card.  tests/conftest.py
imports JAX, which the card's machine lacks, so run them there with

    python3 -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_sampler_card.py
"""

import numpy as np
import pytest
import torch

from shimmer_tpu_torch import samplers
from shimmer_tpu_torch.bench_scene import build_bench_scene
from shimmer_tpu_torch.ops import sampler as zk
from shimmer_tpu_torch.render import render
from shimmer_tpu_torch.utils import stats

pytestmark = pytest.mark.card

RES = (1280, 720)
SPP = 16
SEED = 3_000_000_019


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    return torch.device("cuda")


def _torch_code(monkeypatch):
    """From here on, ZSobol runs its torch code on CUDA tensors too."""
    monkeypatch.setattr(samplers, "_on_card", lambda t: False)


def _draws(smp, state):
    u1, s1 = smp.get_1d(state)
    u2, s2 = smp.get_2d(state)
    up, sp = smp.get_pixel_2d(state)
    return u1, s1.dim, u2, s2.dim, up, sp.dim


def test_kernels_equal_the_torch_code_at_the_diffuse_cell(card, monkeypatch):
    smp = samplers.ZSobolSampler(SPP, RES, SEED)
    ys, xs = torch.meshgrid(torch.arange(RES[1]), torch.arange(RES[0]), indexing="ij")
    pixel_xy = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1).to(card, torch.int32)
    n = pixel_xy.shape[0]
    rng = np.random.default_rng(5)
    per_lane = torch.from_numpy(rng.integers(0, SPP, n)).to(card)
    sample_indices = (per_lane, torch.tensor(SPP - 1, device=card), 3)
    dim = torch.from_numpy(rng.integers(0, 65, n)).to(card)

    def run():
        starts = [smp.start_pixel_sample(pixel_xy, si) for si in sample_indices]
        state = samplers.SamplerState(starts[0].pixel_hash, starts[0].sample_index, dim)
        out = [t for s in starts for t in (s.pixel_hash, s.sample_index, s.dim)]
        return out + list(_draws(smp, state)) + list(_draws(smp, starts[1]))

    zk.reset_launches()
    kernel = run()
    torch.cuda.synchronize()
    counts = {"zsobol_start": 3, "zsobol_draw<1>": 2, "zsobol_draw<2>": 4}
    assert zk.launch_counts() == counts
    _torch_code(monkeypatch)
    plain = run()
    assert zk.launch_counts() == counts
    for k, p in zip(kernel, plain):
        assert k.dtype == p.dtype and torch.equal(k, p.expand_as(k))


def test_every_zsobol_call_of_a_block_wave_launches_inside_its_span(card, monkeypatch):
    scene, cam, film = build_bench_scene(20_000, (64, 48), device=card)
    smp = samplers.ZSobolSampler(4, film.resolution, SEED)
    zk.reset_launches()
    inner = {"zsobol_start": [], "zsobol_draw": []}
    for name, seen in inner.items():
        original = getattr(zk, name)

        def recording(*args, _original=original, _seen=seen, **kwargs):
            _seen.append(stats._tls.stack[-1][1].name)
            return _original(*args, **kwargs)

        recording.launches = original.launches
        monkeypatch.setattr(zk, name, recording)
    stats.clear()
    render(scene, cam, film, smp, "path", spp=4, max_depth=5, wave_spp=4,
           pixel_block=64 * 48)
    torch.cuda.synchronize()
    calls = {name: stats.span(name).calls for name in ("sampler/start", "sampler/draw")}
    stats.clear()
    assert calls["sampler/start"] > 0 and calls["sampler/draw"] > 0
    counts = zk.launch_counts()
    assert counts["zsobol_start"] == calls["sampler/start"]
    assert counts["zsobol_draw<1>"] + counts["zsobol_draw<2>"] == calls["sampler/draw"]
    assert set(inner["zsobol_start"]) == {"sampler/start"}
    assert set(inner["zsobol_draw"]) == {"sampler/draw"}


@pytest.mark.parametrize("case", ["bench-wavefront", "small-megakernel"])
def test_render_equals_the_torch_code(card, monkeypatch, case):
    if case == "bench-wavefront":
        scene, cam, film = build_bench_scene(device=card)
        opts = dict(spp=4, wave_spp=4, pixel_block=1 << 20)
    else:
        scene, cam, film = build_bench_scene(20_000, (64, 48), device=card)
        opts = dict(spp=4, wave_spp=4, wavefront=False)
    smp = samplers.ZSobolSampler(opts["spp"], film.resolution, SEED)
    zk.reset_launches()
    kernel, _ = render(scene, cam, film, smp, "path", max_depth=5, **opts)
    assert zk.launch_counts()["zsobol_draw<2>"] > 0
    _torch_code(monkeypatch)
    zk.reset_launches()
    plain, _ = render(scene, cam, film, smp, "path", max_depth=5, **opts)
    assert sum(zk.launch_counts().values()) == 0
    assert kernel.float().mean() > 0
    assert torch.equal(kernel, plain)
