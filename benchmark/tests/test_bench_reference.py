"""The frozen plain reference against the port on the CPU at a tiny size,
for each configuration: its pixels against the port's wavefront render,
and its inverse-rendering steps against the grad loop's, through the
port's replay."""

import json
import time

import pytest
from conftest import SEED, TINY

from benchmark import compare, harness
from benchmark import scene as sc
from benchmark.reference.render import render_pixels

BENCH = harness.load_bench()
CONFIGS = [c["name"] for c in BENCH["configs"]]
SPP, DEPTH = 2, 5


def tiny_config(name):
    with open(harness.ROOT / "benchmark" / "configs" / f"{name}.json") as f:
        config = json.load(f)
    config["geometry"]["sphere_tris"] = TINY["sphere_tris"]
    config["resolution"] = TINY["resolution"]
    return config


@pytest.mark.parametrize("name", CONFIGS)
def test_pixels_match_the_port(name):
    from shimmer_tpu_torch.render import render

    config = tiny_config(name)
    geom = sc.geometry(config)
    port, ref = sc.side(sc.PORT), sc.side(sc.REFERENCE)
    ps, pc, pf = sc.build(port, config, geom, "cpu")
    rs, rc, rf = sc.build(ref, config, geom, "cpu")
    res = TINY["resolution"]
    img, _ = render(ps, pc, pf, sc.sampler(port, config, res, SEED, SPP), spp=SPP,
                    max_depth=DEPTH, wave_spp=1, pixel_block=TINY["pixel_block"])
    pix = compare.sample_pixels(res, SEED, res[0] * res[1], "cpu")
    want, rays = render_pixels(rs, rc, rf, sc.sampler(ref, config, res, SEED, SPP), pix, SPP,
                               DEPTH)
    got = img[pix[:, 1].long(), pix[:, 0].long()]
    assert rays > 0 and float(want.mean()) > 0
    assert float(compare.pixel_gaps(got, want).max()) <= 1e-6


@pytest.mark.parametrize("name", CONFIGS)
def test_grad_steps_match_the_port(name):
    """The grad loop's followed steps through the port's replay against
    the reference's, each number held to 1e-6."""
    traffic = next(t for w in BENCH["workloads"]
                   for t in [harness.load_cell(BENCH, w["name"])[2]]
                   if t["kind"] == "grad_steps")
    config = tiny_config(name)
    config["limits"]["grad_steps"] = dict.fromkeys(("loss_gap", "grad_gap", "change_gap"), 1e-6)
    run = harness.Run(BENCH, {}, config, dict(traffic, pixel_block=TINY["pixel_block"]), SEED,
                      0.0, False, time.perf_counter(), device="cpu")
    grad_loop = harness.module("loops", "grad_steps")
    grad_loop.first_steps(run)
    assert len(run.judge["losses"]) == grad_loop.FOLLOWED
    assert float(run.judge["change"].abs().max()) > 0
    numbers = grad_loop.check(run)
    assert all(n["value"] <= n["limit"] for n in numbers.values()), numbers
