"""Two-process dry run of the multi-process path: two gloo processes on
the CPU, four band devices each, render the flagship over the 8-band
global mesh (``parallel.distributed.render_multihost``) and run the
sharded training step (``flagship.dryrun_multichip``, the gradient
all-reduced); both processes must print the same image mean.

    python -m shimmer_tpu_torch.experiments.dryrun_multihost [--out DIR]

``--out`` keeps each process's image and gradient as
``image<rank>.npy`` / ``grad<rank>.npy``.  The workers join on a free
localhost port (``worker <rank> <port> <out>`` is a worker's command
line).
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
from pathlib import Path

N_PROC = 2
N_LOCAL = 4
RES = (16, 16)
ROOT = Path(__file__).resolve().parents[2]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def worker(rank: int, port: int, out: str):
    import numpy as np
    import torch
    import torch.distributed as dist

    from shimmer_tpu_torch.flagship import dryrun_multichip, flagship
    from shimmer_tpu_torch.parallel.distributed import initialize_distributed, render_multihost
    from shimmer_tpu_torch.samplers import IndependentSampler

    torch.set_num_threads(1)
    initialize_distributed(f"localhost:{port}", N_PROC, rank, device="cpu")
    try:
        bands = ["cpu"] * N_LOCAL
        scene, cam, film = flagship(RES, "cpu")
        img = render_multihost(scene, cam, film, IndependentSampler(2, seed=3), spp=2,
                               max_depth=2, wave_spp=2, devices=bands).numpy()
        dry = dryrun_multichip(bands)
        if not (np.isfinite(img).all() and img.mean() > 0):
            raise RuntimeError(f"image mean {img.mean()}")
        if out:
            np.save(Path(out) / f"image{rank}.npy", img)
            np.save(Path(out) / f"grad{rank}.npy", dry["grad"])
        print(f"WORKER{rank} OK mean={img.mean():.6f}", flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="two gloo processes of four CPU bands each")
    ap.add_argument("--out", default="", help="directory for each rank's image and gradient")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-m", "shimmer_tpu_torch.experiments.dryrun_multihost",
                               "worker", str(rank), str(port), args.out],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for rank in range(N_PROC)]
    try:
        outs = [p.communicate(timeout=args.timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    means = []
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or f"WORKER{rank} OK" not in out:
            print(f"--- worker {rank} rc={p.returncode} ---\n{out[-3000:]}")
            return 1
        means.append(out.split(f"WORKER{rank} OK mean=")[1].split()[0])
    if means[0] != means[1]:
        print(f"processes disagree: {means}")
        return 1
    print(f"MULTIHOST DRYRUN OK: {N_PROC} processes x {N_LOCAL} bands, mean={means[0]}")
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "worker":
        worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4] if len(sys.argv) > 4 else "")
    else:
        sys.exit(main())
