"""One process a band across a job (``parallel/distributed.py``) on the CPU:
four gloo processes, one band each, render a small bench frame (the
displaced sphere over the floor, ZSobol, depth 5) through
``render_multihost``; every rank's image equals one process's
``render_sharded`` over four CPU bands and lies within 1e-5 of the
unsharded ``render``; each band's render is one ``shard/band`` span a wave
and each frame's gather one ``shard/gather`` span.  ``initialize_distributed``
with a ``timeout`` raises in bounded time when a process never joins, and
``cli.py --shard`` under ``torch.distributed.run`` writes, from rank 0
alone, the image the run without ``--shard`` writes."""

import os

os.environ.setdefault("OMP_NUM_THREADS", "1")

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from shimmer_tpu_torch.bench_scene import build_bench_scene
from shimmer_tpu_torch.experiments.dryrun_multihost import free_port
from shimmer_tpu_torch.film.image import Image
from shimmer_tpu_torch.parallel.render import make_tile_mesh, render_sharded
from shimmer_tpu_torch.render import render
from shimmer_tpu_torch.samplers import ZSobolSampler

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SCENE = Path(__file__).parent / "scenes" / "diffuse_box.pbrt"
N_PROC = 4
RES = (16, 8)
TRIS = 320
SPP, WAVE_SPP, DEPTH, SEED = 4, 2, 5, 3_000_000_019
FRAMES = 2

WORKER = """
import json, sys
import numpy as np, torch
import torch.distributed as dist
from shimmer_tpu_torch.bench_scene import build_bench_scene
from shimmer_tpu_torch.parallel.distributed import initialize_distributed, render_multihost
from shimmer_tpu_torch.samplers import ZSobolSampler
from shimmer_tpu_torch.utils import stats

rank, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
res, tris, spp, wave_spp, depth, seed, frames, world = json.loads(sys.argv[4])
torch.set_num_threads(1)
initialize_distributed(f"localhost:{port}", world, rank, device="cpu", timeout=50)
scene, cam, film = build_bench_scene(tris, tuple(res), "cpu")
stats.clear()
for _ in range(frames):
    img = render_multihost(scene, cam, film, ZSobolSampler(spp, tuple(res), seed=seed), spp=spp,
                           max_depth=depth, wave_spp=wave_spp)
names = [r.name for r in stats.spans()]
np.save(f"{out}/image{rank}.npy", img.numpy())
with open(f"{out}/spans{rank}.json", "w") as f:
    json.dump({"band": names.count("shard/band"), "gather": names.count("shard/gather"),
               "band_waves": stats.as_dict().get("Shard/Band waves", 0.0)}, f)
dist.destroy_process_group()
"""


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")


def test_four_processes_one_band_each(tmp_path):
    port = free_port()
    args = json.dumps([RES, TRIS, SPP, WAVE_SPP, DEPTH, SEED, FRAMES, N_PROC])
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(port), str(tmp_path),
                               args], cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(N_PROC)]
    try:
        outs = [p.communicate(timeout=55)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-3000:]}"
    images = [np.load(tmp_path / f"image{r}.npy") for r in range(N_PROC)]
    assert all(np.array_equal(images[0], im) for im in images[1:])

    scene, cam, film = build_bench_scene(TRIS, RES, "cpu")
    smp = lambda: ZSobolSampler(SPP, RES, seed=SEED)  # noqa: E731
    kw = dict(spp=SPP, max_depth=DEPTH, wave_spp=WAVE_SPP)
    one, _ = render_sharded(scene, cam, film, smp(), make_tile_mesh(["cpu"] * N_PROC), **kw)
    np.testing.assert_array_equal(images[0], one.numpy())
    whole, _ = render(scene, cam, film, smp(), **kw)
    assert float(whole.mean()) > 0
    np.testing.assert_allclose(images[0], whole.numpy(), rtol=1e-5, atol=1e-5)

    waves = -(-SPP // WAVE_SPP)
    for r in range(N_PROC):
        counts = json.loads((tmp_path / f"spans{r}.json").read_text())
        assert counts == {"band": FRAMES * waves, "gather": FRAMES,
                          "band_waves": FRAMES * waves}, (r, counts)


JOIN_ALONE = """
import sys, time
from shimmer_tpu_torch.parallel.distributed import initialize_distributed
t = time.perf_counter()
try:
    initialize_distributed(f"localhost:{sys.argv[1]}", 2, 0, device="cpu", timeout=3)
except Exception as e:
    print(f"RAISED {type(e).__name__} after {time.perf_counter() - t:.1f} s", flush=True)
    sys.exit(7)
print("JOINED", flush=True)
"""


def test_initialize_distributed_times_out_when_a_process_never_joins():
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", JOIN_ALONE, str(free_port())], cwd=ROOT,
                          env=_env(), capture_output=True, text=True, timeout=55)
    assert proc.returncode == 7, proc.stdout + proc.stderr[-2000:]
    assert "RAISED" in proc.stdout
    # Process start and imports, then the 3-s wait: far below NCCL's 10 minutes.
    assert time.perf_counter() - t < 50


def test_cli_shard_under_torchrun_writes_the_unsharded_image(tmp_path):
    plain, sharded = tmp_path / "plain.pfm", tmp_path / "sharded.pfm"
    args = [str(SCENE), "--spp", "1", "--device", "cpu", "-q"]
    run = lambda cmd: subprocess.run(cmd, cwd=tmp_path, env=_env(), capture_output=True,  # noqa: E731
                                     text=True, timeout=55)
    proc = run([sys.executable, "-m", "shimmer_tpu_torch.cli", *args, "-o", str(plain)])
    assert proc.returncode == 0, proc.stderr[-2000:]
    proc = run([sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
                "--master-port", str(free_port()), "-m", "shimmer_tpu_torch.cli", *args[:-1],
                "--shard", "-o", str(sharded)])
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert proc.stderr.count(f"wrote {sharded}") == 1, proc.stderr[-3000:]
    np.testing.assert_array_equal(Image.read(sharded).data, Image.read(plain).data)
