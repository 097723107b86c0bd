"""``frames``: final frames back to back in a closed loop through the
port's ``render`` (the wavefront), the ZSobol seed of frame ``f`` being
the run's seed plus ``f``.  The traffic gives ``spp``, ``wave_spp`` and
``pixel_block``; the configuration the depth.

A wave counts when it ends inside the window.  The frame in flight at
the close is dropped at its first wave that ends after it, so a run
lasts the window and at most one wave more; the check judges the last
frame that completed: a sample of its pixels, drawn from the seed,
recomputed by the plain reference from the same inputs (its own scene,
BVH and sampler).
"""

from __future__ import annotations

import sys
import time

import torch

from benchmark import compare, port
from benchmark import scene as sc
from benchmark.reference.render import render_pixels
from benchmark.trace import profiled


class _Closed(Exception):
    """The window closed with the frame in flight not done."""


def loop(run):
    from shimmer_tpu_torch import render as rd
    from shimmer_tpu_torch.utils import stats

    t = run.traffic
    dev = run.device
    api, (scene, cam, film) = port.build(run)
    run.port = (scene, cam, film)
    res = film.resolution
    n_px = res[0] * res[1]
    spp, wave_spp, block = int(t["spp"]), int(t["wave_spp"]), int(t["pixel_block"])
    depth = int(run.config["integrator"]["maxdepth"])
    lanes = min(block, n_px)

    def block_wave(seed, n_spp):
        """One ``n_spp`` wave of block 0, as render() runs each block-wave."""
        smp = sc.sampler(api, run.config, res, seed, spp)
        wave = rd.make_wavefront_renderer(scene, cam, film, smp, max_depth=depth)
        blocks, valids = rd.pixel_blocks(film, block, dev)
        idx = torch.arange(n_spp, dtype=torch.int64, device=dev)
        state, st = wave(film.init_state(dev), idx, blocks[0], valids[0])
        film.get_image(state)
        port.sync(dev)
        return st

    # Warm-up: every kernel of the path, at one sample a lane.
    t = time.perf_counter()
    block_wave(run.seed - 1, 1)
    run.e2e["setup_s"] = time.perf_counter() - run.t0
    print(f"setup: warm-up block-wave {run.e2e['setup_s'] + run.t0 - t:.3f} s", file=sys.stderr)

    stats.clear()
    start = time.perf_counter()
    deadline = start + run.seconds
    mark = {"samples": 0, "t": start, "waves": 0, "rays": 0.0, "iters": 0.0, "done": 0,
            "ends": []}
    frame, judged = 0, None
    while True:
        mark["done"] = 0

        def progress(done, total):
            port.sync(dev)
            now = time.perf_counter()
            mark["ends"].append(now - start)
            if now > deadline and done < total:
                raise _Closed
            if now <= deadline:
                mark["samples"] += n_px * (done - mark["done"])
                mark["t"] = now
                mark["waves"] += 1
                if run.trace:
                    counts = stats.as_dict()
                    mark["rays"] = counts.get("Integrator/Rays traced", 0.0)
                    mark["iters"] = counts.get("Integrator/Wavefront iterations", 0.0)
            mark["done"] = done

        smp = sc.sampler(api, run.config, res, run.seed + frame, spp)
        try:
            out = rd.render(scene, cam, film, smp, spp=spp, max_depth=depth, wave_spp=wave_spp,
                            pixel_block=block, progress=progress, collect_stats=run.trace)
        except _Closed:
            break
        run.attempted += 1
        if not bool(torch.isfinite(out[0]).all()):
            run.failed += 1
        judged = (out[0], run.seed + frame)
        frame += 1
        if time.perf_counter() >= deadline:
            break
    if mark["waves"] == 0 or judged is None:
        raise RuntimeError(f"no wave or no frame ended inside the {run.seconds}-s window")
    window_s = mark["t"] - start
    print(f"waves end at (s into the window): {[round(e, 3) for e in mark['ends']]}",
          file=sys.stderr)
    run.e2e["msamples_per_s"] = mark["samples"] / 1e6 / window_s
    run.data.update(window_s=window_s, samples=mark["samples"], waves=mark["waves"],
                    frames=frame, rays=mark["rays"], iters=mark["iters"], lanes=lanes)
    run.judge = {"image": judged[0], "frame_seed": judged[1], "spp": spp, "max_depth": depth,
                 "resolution": res}
    if run.trace and dev.type == "cuda":
        # One steady block-wave under the profiler.
        st, run.profile = profiled(lambda: block_wave(run.seed + frame, wave_spp))
        run.profile["iters"] = float(st["iters"])


def check(run) -> dict:
    j = run.judge
    pix = compare.sample_pixels(j["resolution"], run.seed, compare.SAMPLED_PIXELS, run.device)
    got = j["image"][pix[:, 1].long(), pix[:, 0].long()].to(torch.float32)
    j["image"] = None
    scene, cam, film = run.reference()
    api = sc.side(sc.REFERENCE)
    smp = sc.sampler(api, run.config, j["resolution"], j["frame_seed"], j["spp"])
    want, _ = render_pixels(scene, cam, film, smp, pix, j["spp"], j["max_depth"])
    print(f"check frames: {pix.shape[0]} pixels of frame seed {j['frame_seed']}",
          file=sys.stderr)
    return compare.frames_numbers(got, want, compare.limits(run.config, "frames"))


def control(config, traffic, seed, variant, device):
    """The check's numbers with the reference in the program's place at
    ``variant``'s precision (``tf32``, ``bf16``) on frame seed ``seed``."""
    api = sc.side(sc.REFERENCE)
    scene, cam, film = sc.build(api, config, sc.geometry(config), device)
    spp = int(traffic["spp"])
    depth = int(config["integrator"]["maxdepth"])
    pix = compare.sample_pixels(film.resolution, seed, compare.SAMPLED_PIXELS, device)
    smp = lambda: sc.sampler(api, config, film.resolution, seed, spp)
    want, _ = render_pixels(scene, cam, film, smp(), pix, spp, depth)
    got, _ = render_pixels(scene, cam, film, smp(), pix, spp, depth, precision=variant)
    return compare.frames_numbers(got, want, compare.limits(config, "frames"))
