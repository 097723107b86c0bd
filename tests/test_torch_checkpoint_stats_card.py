"""Render checkpoints and the film's splats on the card:

* ``RgbFilm.add_splats`` of 2^20 samples (~114 a pixel, Gaussian
  footprints, some over the film's edges) twice on the card, the same
  bits, and within rtol 1e-4 of the CPU;
* a checkpointed render of the bench scene at 320x180, 4 spp, one sample
  a wave, in a process of its own that is killed after its second wave,
  resumed in another new process: its final film state ``torch.equal`` to
  an uninterrupted render's.

Marked ``card``; run on the card as tests/card_checks.py says.  Run as a
script, this file is the checkpointed render's process:

    python3 tests/test_torch_checkpoint_stats_card.py CHECKPOINT [KILL_AFTER]
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from card_checks import BLOCK, CONFIGS, MAX_DEPTH, card, launches, reset_launches  # noqa: F401
from shimmer_tpu_torch.bench_scene import BENCH_TRIS, build_bench_scene
from shimmer_tpu_torch.color.colorspace import get_named_color_space
from shimmer_tpu_torch.film.film import PixelSensor, RgbFilm
from shimmer_tpu_torch.film.filters import GaussianFilter
from shimmer_tpu_torch.render import render
from shimmer_tpu_torch.samplers import ZSobolSampler
from shimmer_tpu_torch.spectra.sampled import SampledWavelengths

pytestmark = pytest.mark.card

ROOT = Path(__file__).resolve().parent.parent
CHECKPOINT_RES = (320, 180)
CHECKPOINT_SPP = 4
KILL_AFTER = 2
KILLED_EXIT = 17
SPLAT_RES = (128, 72)
SPLAT_SAMPLES = 1 << 20
SPLAT_RTOL, SPLAT_ATOL = 1e-4, 1e-6   # card vs CPU, the atol of the image's largest value


def splat_film():
    cs = get_named_color_space("srgb")
    return RgbFilm(SPLAT_RES, GaussianFilter(1.5, 1.5, 0.6), PixelSensor(cs), cs)


def splat(device) -> torch.Tensor:
    """The splatted plane of SPLAT_SAMPLES samples made from a seed on the
    host, with their wavelengths (sampled on the host: the card's
    transcendentals round an ulp apart, which moved a few samples' colors
    by up to 4.3% when each device sampled its own)."""
    g = torch.Generator().manual_seed(16)
    w, h = SPLAT_RES
    p = torch.rand((SPLAT_SAMPLES, 2), generator=g) * torch.tensor([w + 2.0, h + 2.0]) - 1.0
    lrad = torch.exp(torch.randn((SPLAT_SAMPLES, 4), generator=g))
    film = splat_film()
    swl = film.sample_wavelengths(torch.rand(SPLAT_SAMPLES, generator=g))
    swl = SampledWavelengths(lam=swl.lam.to(device), pdf=swl.pdf.to(device))
    return film.add_splats(film.init_state(device), p.to(device), lrad.to(device), swl).rgb_splat


def test_splats_repeat_on_the_card_and_agree_with_the_cpu(card):
    first, second = splat(card), splat(card)
    assert torch.equal(first, second)
    got, cpu = first.cpu().numpy(), splat("cpu").numpy()
    assert np.isfinite(got).all()
    assert (np.abs(got - cpu) <= SPLAT_RTOL * np.abs(cpu) + SPLAT_ATOL * np.abs(cpu).max()).all()


def checkpoint_render(device, ckpt=None, kill_after=None):
    """The bench scene at CHECKPOINT_RES with ``ckpt`` as its checkpoint
    file; ``kill_after`` ends the process (os._exit, no clean-up) once that
    many waves are done."""
    scene, cam, film = build_bench_scene(BENCH_TRIS, CHECKPOINT_RES, device="cpu")
    scene = scene.to(device)
    scene = dataclasses.replace(scene, triangles=scene.triangles.with_traverse(CONFIGS["v1"]))

    def progress(done, total):
        if done == kill_after:
            os._exit(KILLED_EXIT)

    return render(scene, cam, film, ZSobolSampler(CHECKPOINT_SPP, CHECKPOINT_RES),
                  spp=CHECKPOINT_SPP, max_depth=MAX_DEPTH, wave_spp=1, pixel_block=BLOCK,
                  checkpoint_path=ckpt, progress=progress)


def render_in_a_process(ckpt: Path, kill_after=None) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(ROOT), os.environ.get("PYTHONPATH")])))
    args = [sys.executable, __file__, str(ckpt)] + ([str(kill_after)] if kill_after else [])
    return subprocess.Popen(args, cwd=ROOT, env=env)


def test_a_killed_render_resumes_to_the_uninterrupted_state(card, tmp_path):
    ckpt = tmp_path / "bench.ckpt.npz"
    killed = render_in_a_process(ckpt, KILL_AFTER)
    try:
        reset_launches()
        _, whole = checkpoint_render(card)
        launches("v1")
        assert killed.wait(timeout=600) == KILLED_EXIT
    finally:
        killed.kill()
    with np.load(ckpt) as z:
        assert int(z["spp_done"]) == KILL_AFTER
    resumed = render_in_a_process(ckpt)
    assert resumed.wait(timeout=600) == 0
    with np.load(ckpt) as z:
        assert int(z["spp_done"]) == CHECKPOINT_SPP
        for name in ("rgb_sum", "weight_sum", "rgb_splat"):
            assert torch.equal(torch.from_numpy(z[name]), getattr(whole, name).cpu()), name


if __name__ == "__main__":
    checkpoint_render(torch.device("cuda", 0), sys.argv[1],
                      int(sys.argv[2]) if len(sys.argv) > 2 else None)
