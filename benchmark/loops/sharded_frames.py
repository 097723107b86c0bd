"""``sharded_frames``: final frames back to back over a deployment of
several cards, one process a card, through the port's
``parallel.distributed.render_multihost``: each process renders its row
band of every frame as one lane pool of the regenerating wavefront, then
the bands are gathered on every process in rank order.  The
configuration's ``deployment`` gives ``processes``; the traffic ``spp``
and ``wave_spp``, the configuration the depth; frame ``f``'s ZSobol seed
is the run's seed plus ``f``.

The harness's process is rank 0.  Ranks 1 .. processes - 1 are spawned
from it, each on card ``cuda:<rank>``, and all join one NCCL world on a
free localhost port, with a timeout (``initialize_distributed``).  Each
builds the scene on its own card and renders a warm-up frame at 1 spp;
set-up ends when all meet at a barrier.  A frame counts when its gathered
image is on rank 0 inside the window; after each frame rank 0 broadcasts
whether to go on, so the frame in flight at the close finishes on every
rank but is not counted.  The check judges the last counted frame as the
``frames`` loop does: sampled pixels against the reference's unsharded
recomputation.

After the window rank 0 collects from every rank its ``shard/band`` time
of each frame (``band_imbalance_pct``), its peak memory and its loaded
modules (the run fails if any rank loaded JAX or the JAX package).
Under ``--trace 1`` every rank profiles one more frame; rank 0 keeps its
own profile and the smallest device time of the operations launched
inside ``shard/gather`` (``gather_ms``).  If a rank dies, rank 0 ends the
others and exits non-zero.

On the CPU (the tests) the world is gloo, of the most ranks, at most
``processes``, that split the frame's rows evenly, and the ranks share
rank 0's torch threads.
"""

from __future__ import annotations

import os
import runpy
import socket
import sys
import threading
import time
import traceback
from pathlib import Path

import torch

from benchmark import compare, harness, port, stages, trace
from benchmark import scene as sc

ROOT = Path(__file__).resolve().parents[2]
_frames = harness.module("loops", "frames", ROOT)
control = _frames.control

# Seconds for every rank to join, and for each collective after: above the
# spread of the ranks' set-up times (a checkout's first run builds the
# kernel libraries in every process).
JOIN_S = 300.0
# A spawned rank runs this file by path, as the harness loaded it, under this name.
_CHILD = "__sharded_frames_rank__"


def world_size(run) -> int:
    """The ranks of the run: the deployment's processes on the card, where
    they must equal the cell's chips."""
    processes = int(run.config["deployment"]["processes"])
    if run.device.type == "cuda":
        if processes != int(run.cell["chips"]):
            raise ValueError(f"the deployment has {processes} processes, the cell "
                             f"{run.cell['chips']} chips: one process a card")
        return processes
    rows = int(run.config["resolution"][1])
    return max(w for w in range(1, processes + 1) if rows % w == 0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class _Ranks:
    """The spawned ranks, watched from a thread of rank 0: if one exits
    with an error before the run is done, the others are ended and the
    process exits non-zero."""

    def __init__(self, procs):
        self.procs = procs
        self.done = threading.Event()
        self.watcher = threading.Thread(target=self._watch, daemon=True)
        self.watcher.start()

    def _watch(self):
        while not self.done.wait(0.2):
            for rank, p in enumerate(self.procs, start=1):
                if p.exitcode not in (None, 0):
                    print(f"sharded_frames: rank {rank} exited with {p.exitcode}; ending the "
                          "others", file=sys.stderr, flush=True)
                    self.end(grace=0.0)
                    os._exit(5)

    def end(self, grace: float):
        """Wait up to ``grace`` seconds for the ranks to exit, then end them."""
        deadline = time.monotonic() + grace
        for p in self.procs:
            p.join(max(0.0, deadline - time.monotonic()))
        for p in self.procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
            if p.is_alive():
                p.kill()
                p.join(5)

    def close(self, grace: float):
        self.done.set()
        self.watcher.join()
        self.end(grace)


def loop(run):
    world = world_size(run)
    port_no = _free_port()
    threads = torch.get_num_threads()
    share = threads if run.device.type == "cuda" else max(1, threads // world)
    spec = dict(bench=run.bench, cell=run.cell, config=run.config, traffic=run.traffic,
                seed=run.seed, seconds=run.seconds, trace=run.trace, root=str(run.root),
                device=run.device.type, world=world, port=port_no, threads=share)
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=runpy.run_path, args=(__file__,), daemon=True,
                         kwargs=dict(run_name=_CHILD, init_globals=dict(SPEC=spec, RANK=rank)))
             for rank in range(1, world)]
    for p in procs:
        p.start()
    ranks = _Ranks(procs)
    ok = False
    torch.set_num_threads(share)
    try:
        everyone = _rank(run, 0, world, port_no)
        ok = True
    finally:
        torch.set_num_threads(threads)
        ranks.close(grace=60.0 if ok else 0.0)
    _collect(run, everyone)


def _rank(run, rank: int, world: int, port_no: int):
    """One rank's part: join, build, warm up, the window, then what rank 0
    collects (every rank's, on rank 0; None elsewhere)."""
    import torch.distributed as dist

    from shimmer_tpu_torch.parallel.distributed import initialize_distributed, render_multihost
    from shimmer_tpu_torch.utils import stats

    if run.device.type == "cuda":
        run.device = torch.device("cuda", rank)
        torch.cuda.set_device(run.device)
    dev = run.device
    initialize_distributed(f"localhost:{port_no}", world, rank, device=dev, timeout=JOIN_S)
    t = run.traffic
    api, (scene, cam, film) = port.build(run)
    run.port = (scene, cam, film)
    res = film.resolution
    spp, wave_spp = int(t["spp"]), int(t["wave_spp"])
    depth = int(run.config["integrator"]["maxdepth"])

    def frame(seed, n_spp=spp):
        smp = sc.sampler(api, run.config, res, seed, spp)
        return render_multihost(scene, cam, film, smp, spp=n_spp, max_depth=depth,
                                wave_spp=wave_spp)

    # Warm-up: every kernel of the path and the collective, at one sample a pixel.
    frame(run.seed - 1, 1)
    port.sync(dev)
    dist.barrier()
    setup_s = time.perf_counter() - run.t0
    if rank == 0:
        print(f"sharded_frames: {world} ranks set up in {setup_s:.3f} s; the window opens",
              file=sys.stderr, flush=True)

    stats.clear()
    band = stats.span("shard/band")
    go = torch.ones(1, dtype=torch.int32, device=dev)
    band_s = []
    counted, judged = 0, None
    start = time.perf_counter()
    deadline, last = start + run.seconds, start
    f = 0
    while True:
        b0 = band.seconds
        image = frame(run.seed + f)
        band_s.append(band.seconds - b0)
        if rank == 0:
            port.sync(dev)
            now = time.perf_counter()
            if now <= deadline:
                counted, last, judged = counted + 1, now, (image, run.seed + f)
                run.attempted += 1
                run.failed += not bool(torch.isfinite(image).all())
            go.fill_(int(now < deadline))
        dist.broadcast(go, src=0)
        f += 1
        if not int(go.item()):
            break

    gather_s = profile = None
    if run.trace and dev.type == "cuda":
        stats.clear()
        profile, gather_s = _profiled(lambda: frame(run.seed + f), stats, dev)
    mine = {"band_s": band_s, "gather_s": gather_s, "modules": harness.forbidden_modules(),
            "peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0}
    everyone = [None] * world
    dist.all_gather_object(everyone, mine)
    dist.destroy_process_group()
    if rank != 0:
        return None
    if counted == 0:
        raise RuntimeError(f"no frame ended inside the {run.seconds}-s window")
    window_s = last - start
    run.e2e["setup_s"] = setup_s
    run.e2e["msamples_per_s"] = res[0] * res[1] * spp * counted / 1e6 / window_s
    run.data.update(window_s=window_s, frames=counted, bands=world)
    run.profile = profile
    run.judge = {"image": judged[0], "frame_seed": judged[1], "spp": spp, "max_depth": depth,
                 "resolution": res, "bands": world}
    return everyone


def _profiled(fn, stats, dev):
    """One frame under torch.profiler's CUDA activity: (``trace.summarize``
    of it, as ``trace.profiled`` gives it, and the device seconds of the
    operations launched inside ``shard/gather``, by ``stages.attribute``)."""
    from torch.profiler import ProfilerActivity, profile

    port.sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0_ns, t0 = time.time_ns(), time.perf_counter()
        fn()
        port.sync(dev)
        window_s = time.perf_counter() - t0
        t1_ns = time.time_ns()
    on_dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        span = (e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9, e.name())
        (on_dev if e.device_type() == torch.autograd.DeviceType.CUDA else host).append(span)
    ops, launches = stages.events(prof)
    records = [r for r in stats.spans() if t0_ns <= r.start_ns and r.end_ns <= t1_ns]
    a = stages.attribute(ops, launches, records)
    nccl = sum(e - s for s, e, _, name in ops if "nccl" in name.lower()) * 1e-9
    print(f"sharded_frames: traced frame {window_s:.6f} s, device under shard/gather "
          f"{a['busy_by_span'].get('shard/gather')!r} s, nccl kernels {nccl!r} s, launches "
          f"outside any span {a['launches_outside']}", file=sys.stderr)
    return trace.summarize(on_dev, host, window_s), a["busy_by_span"].get("shard/gather")


def _collect(run, everyone):
    """Rank 0's reading of what every rank gave after the window."""
    counted = run.data["frames"]
    found = sorted({m for r in everyone for m in r["modules"]})
    if found:
        raise RuntimeError(f"a rank loaded modules of JAX or of the JAX package: {found}")
    band = [sum(r["band_s"][:counted]) for r in everyone]
    peaks = [r["peak_bytes"] for r in everyone]
    gathers = [r["gather_s"] for r in everyone]
    print(f"sharded_frames: {counted} frames counted; shard/band seconds by rank {band!r}; "
          f"peak bytes by rank {peaks!r}; device seconds under shard/gather by rank "
          f"{gathers!r}", file=sys.stderr)
    mean = sum(band) / len(band)
    run.data["band_imbalance_pct"] = (100.0 * (max(band) / mean - 1.0)
                                      if min(band) > 0 else None)
    run.data["gather_ms"] = (1e3 * min(gathers) if all(g is not None for g in gathers)
                             else None)
    run.data["setup_peak_bytes"] = max(peaks)


def check(run) -> dict:
    j = run.judge
    rows = j["resolution"][1] // j["bands"]
    pix = compare.sample_pixels(j["resolution"], run.seed, compare.SAMPLED_PIXELS, "cpu")
    by_band = torch.bincount(pix[:, 1].long() // rows, minlength=j["bands"])
    print(f"check sharded_frames: sampled pixels by band {by_band.tolist()}", file=sys.stderr)
    return _frames.check(run)


def _child(spec: dict, rank: int):
    """A spawned rank: its own Run, its part, then exit (with 1 on any
    error, or when rank 0's process is gone)."""
    parent = os.getppid()

    def orphaned():
        while os.getppid() == parent:
            time.sleep(0.5)
        os._exit(1)

    threading.Thread(target=orphaned, daemon=True).start()
    try:
        torch.set_num_threads(spec["threads"])
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        run = harness.Run(spec["bench"], spec["cell"], spec["config"], spec["traffic"],
                          spec["seed"], spec["seconds"], spec["trace"], time.perf_counter(),
                          device=spec["device"])
        run.root = Path(spec["root"])
        _rank(run, rank, spec["world"], spec["port"])
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    sys.stderr.flush()
    sys.stdout.flush()
    os._exit(0)


if __name__ == _CHILD:
    _child(SPEC, RANK)  # noqa: F821 (given by runpy.run_path's init_globals)
