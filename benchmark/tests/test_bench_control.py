"""The check fails what it must: the control (the reference put in the
program's place in a lower precision) at a tiny size, and a run whose
timed path is broken underneath, once for each fault a cell can have,
and a grad loop that renders stale parameters.  The cells run on one
chip, so no cell has an exchange between chips to leave out."""

import pytest
import torch
from conftest import SEED, TINY, tiny_run

from benchmark import harness

BENCH = harness.load_bench()
CELLS = [w["name"] for w in BENCH["workloads"]]


def _config_traffic(cell):
    c, config, traffic = harness.load_cell(BENCH, cell)
    config["geometry"]["sphere_tris"] = TINY["sphere_tris"]
    config["resolution"] = TINY["resolution"]
    traffic = dict(traffic, pixel_block=TINY["pixel_block"])
    if traffic["kind"] == "frames":
        traffic.update(spp=2)
    return config, traffic


@pytest.mark.parametrize("cell", CELLS)
def test_bf16_control_fails(cell):
    config, traffic = _config_traffic(cell)
    loop = harness.module("loops", traffic["kind"])
    numbers = loop.control(config, traffic, SEED, "bf16", "cpu")
    assert any(n["value"] > n["limit"] for n in numbers.values()), numbers


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_tf32_control_fails(cell, card):
    """At the cell's own size: the CPU has no TF32 to switch on."""
    _, config, traffic = harness.load_cell(BENCH, cell)
    numbers = harness.module("loops", traffic["kind"]).control(config, traffic, SEED, "tf32",
                                                                card)
    assert any(n["value"] > n["limit"] for n in numbers.values()), numbers


def _unchanged(monkeypatch):
    """The step returns its state unchanged: a render adds nothing to its
    film; an optimizer step leaves the parameters as they were."""
    from shimmer_tpu_torch import render as rd

    real_render, real_step = rd.render, torch.optim.Adam.step

    def render(scene, camera, film, *a, **k):
        out = real_render(scene, camera, film, *a, **k)
        state = film.init_state(scene.device)
        return (film.get_image(state), state, *out[2:])

    def step(self, *a, **k):
        saved = [p.detach().clone() for g in self.param_groups for p in g["params"]]
        real_step(self, *a, **k)
        with torch.no_grad():
            for p, s in zip((p for g in self.param_groups for p in g["params"]), saved):
                p.copy_(s)

    monkeypatch.setattr(rd, "render", render)
    monkeypatch.setattr(torch.optim.Adam, "step", step)


def _half(monkeypatch):
    """Half of the batch left out: only the first half of the pixel
    blocks is rendered."""
    from shimmer_tpu_torch import render as rd

    real = rd.pixel_blocks

    def pixel_blocks(*a, **k):
        blocks, valids = real(*a, **k)
        n = max(1, blocks.shape[0] // 2)
        return blocks[:n], valids[:n]

    monkeypatch.setattr(rd, "pixel_blocks", pixel_blocks)


def _altered(monkeypatch):
    """An answer altered where it is produced: each sample's RGB, as the
    film weighs it, a thousandth too large."""
    from shimmer_tpu_torch.film.film import RgbFilm

    real = RgbFilm._clamped_rgb
    monkeypatch.setattr(RgbFilm, "_clamped_rgb", lambda self, L, swl: real(self, L, swl) * 1.001)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _half, _altered], ids=["unchanged", "half",
                                                                       "altered"])
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    run = tiny_run(cell)
    fault(monkeypatch)
    line = harness.execute(run)
    assert line["correct"] is False, line["compared"]


GRAD_CELLS = [c for c in CELLS if harness.load_cell(BENCH, c)[2]["kind"] == "grad_steps"]


@pytest.mark.parametrize("cell", GRAD_CELLS)
def test_stale_parameters_are_not_correct(cell, monkeypatch):
    """The grad loop renders every step with the scene of its first: the
    parameters train, the image never sees them."""
    grad_loop = harness.module("loops", "grad_steps")
    real, first = grad_loop.with_rows, []

    def with_rows(*a):
        if not first:
            first.append(real(*a))
        return first[0]

    run = tiny_run(cell)
    monkeypatch.setattr(grad_loop, "with_rows", with_rows)
    line = harness.execute(run)
    assert line["correct"] is False, line["compared"]
    assert line["compared"]["loss_gap"]["value"] > line["compared"]["loss_gap"]["limit"]
