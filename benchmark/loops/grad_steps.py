"""``grad_steps``: inverse-rendering steps in a closed loop.  Each step
renders the image at ``spp`` through the port's replay wavefront
(``make_replay_wavefront_renderer``) over every pixel block, takes the L2
loss to a target image, its gradient with respect to rows ``rows`` of
the scene table at ``param`` (a dotted path, such as
``materials.reflectance``), and one Adam step (``lr``).  Every step
renders the scene with the rows as they stand.  Step ``k``'s ZSobol seed
is the run's seed plus ``k``.

Set-up runs the first ``FOLLOWED`` steps through the window's own step
function: they warm up every kernel, and they are the steps the check
follows.  The window goes on with the same object; a step counts when it
ends inside it.  The check has the plain reference take the same steps
from the same table, target and seeds: each step's loss, the first
gradient, and the rows' change over the steps.  The reference
differentiates the pixels in the traffic's blocks, as the program sums
them: a float32 sum of a row's gradient over 2^20 lanes at once differs
from the blocks' by up to 4e-4 of it.  Two steps and not three, so that
the reference takes about the window's time and not more.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from benchmark import compare, harness, port
from benchmark import scene as sc
from benchmark.reference import grad as ref_grad
from benchmark.reference.grad import table, with_rows
from benchmark.trace import profiled

FOLLOWED = 2


def target_image(resolution, seed: int, device) -> torch.Tensor:
    """(H, W, 3) the inverse-rendering target: a flat color per channel,
    each drawn from ``seed`` in [2, 12)."""
    w, h = resolution
    rng = np.random.default_rng([int(seed) % (1 << 63), 11])
    level = torch.tensor(rng.uniform(2.0, 12.0, 3), dtype=torch.float32, device=device)
    return level.expand(h, w, 3).contiguous()


def first_steps(run):
    """Builds the program's side, runs the followed steps and leaves their
    answers in ``run.judge``.  Returns (the step function, the next
    step's number)."""
    from shimmer_tpu_torch import render as rd

    t = run.traffic
    dev = run.device
    api, (base, cam, film) = port.build(run)
    run.port = (base, cam, film)
    res = film.resolution
    spp, block, lr = int(t["spp"]), int(t["pixel_block"]), float(t["lr"])
    param, rows = t["param"], [int(r) for r in t["rows"]]
    depth = int(run.config["integrator"]["maxdepth"])
    leaf = table(base, param)[rows].detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([leaf], lr=lr)
    target = target_image(res, run.seed, dev)
    blocks, valids = rd.pixel_blocks(film, block, dev)
    idx = torch.arange(spp, dtype=torch.int64, device=dev)
    run.data["bwd_s"] = 0.0

    def step(k: int, timed: bool = False) -> float:
        scene = with_rows(base, param, rows, leaf)
        smp = sc.sampler(api, run.config, res, run.seed + k, spp)
        wave = rd.make_replay_wavefront_renderer(scene, cam, film, smp, max_depth=depth)
        state = film.init_state(dev)
        for b in range(blocks.shape[0]):
            state = wave(scene, state, idx, blocks[b], valids[b])
        loss = ((film.get_image(state) - target) ** 2).mean()
        opt.zero_grad(set_to_none=True)
        if timed:
            port.sync(dev)
            t_b = time.perf_counter()
        loss.backward()
        if timed:
            port.sync(dev)
            run.data["bwd_s"] += time.perf_counter() - t_b
        opt.step()
        port.sync(dev)
        return float(loss.detach())

    t0 = time.perf_counter()
    before = leaf.detach().clone()
    losses = []
    for k in range(FOLLOWED):
        losses.append(step(k))
        if k == 0:
            beta1 = opt.param_groups[0]["betas"][0]
            grad = (opt.state[leaf]["exp_avg"] / (1.0 - beta1)).cpu()
    run.judge = {"losses": losses, "grad": grad, "change": (leaf.detach() - before).cpu(),
                 "before": before.cpu(), "target": target}
    print(f"setup: steps 0-{FOLLOWED - 1} {time.perf_counter() - t0:.3f} s", file=sys.stderr)
    return step, FOLLOWED


def loop(run):
    dev = run.device
    step, k = first_steps(run)
    run.e2e["setup_s"] = time.perf_counter() - run.t0
    if dev.type == "cuda":
        run.data["setup_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    start = time.perf_counter()
    deadline = start + run.seconds
    done, t_last, bwd_s = 0, start, 0.0
    while True:
        loss = step(k, timed=run.trace)
        now = time.perf_counter()
        run.attempted += 1
        if not np.isfinite(loss):
            run.failed += 1
        k += 1
        if now > deadline:
            break
        done, t_last, bwd_s = done + 1, now, run.data["bwd_s"]
    if done == 0:
        raise RuntimeError(f"no step ended inside the {run.seconds}-s window")
    run.e2e["grad_step_s"] = (t_last - start) / done
    run.data.update(window_s=t_last - start, steps=done, bwd_ms=bwd_s * 1e3 / done,
                    peak_bytes=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)
    if run.trace and dev.type == "cuda":
        _, run.profile = profiled(lambda: step(k))


def _reference_steps(config, traffic, seed, ref_side, target, **kw) -> dict:
    scene, cam, film = ref_side
    api = sc.side(sc.REFERENCE)
    spp = int(traffic["spp"])
    return ref_grad.steps(
        scene, cam, film, lambda k: sc.sampler(api, config, film.resolution, seed + k, spp),
        target, traffic["param"], [int(r) for r in traffic["rows"]], spp,
        int(config["integrator"]["maxdepth"]), float(traffic["lr"]), FOLLOWED,
        block=int(traffic["pixel_block"]), **kw)


def check(run) -> dict:
    ref = _reference_steps(run.config, run.traffic, run.seed, run.reference(),
                           run.judge["target"])
    return compare.grad_numbers(run.judge, ref, compare.limits(run.config, "grad_steps"))


def control(config, traffic, seed, variant, device):
    """The check's numbers on seed ``seed`` with the reference in the
    program's place: at ``variant``'s precision (``tf32``, ``bf16``), or
    with a planted fault (``half``, ``altered``), or, for ``program``,
    the program's own followed steps (the lower readings)."""
    if variant == "program":
        run = harness.Run({}, {}, config, traffic, seed, 0.0, False, time.perf_counter(), device)
        first_steps(run)
        run.port = None
        gc.collect()
        return check(run)
    api = sc.side(sc.REFERENCE)
    ref_side = sc.build(api, config, sc.geometry(config), device)
    target = target_image(ref_side[2].resolution, seed, device)
    ref = _reference_steps(config, traffic, seed, ref_side, target)
    kw = {"fault": variant} if variant in ("half", "altered") else {"precision": variant}
    got = _reference_steps(config, traffic, seed, ref_side, target, **kw)
    return compare.grad_numbers(got, ref, compare.limits(config, "grad_steps"))
