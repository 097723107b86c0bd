"""What every loop shares on the program's side: its scene, built from
the configuration, and the card's synchronize."""

from __future__ import annotations

import sys
import time

import torch

from benchmark import scene as sc


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build(run):
    """Geometry from the configuration, then the port's scene on the card.
    Returns (the port's construction API, (scene, camera, film))."""
    t = time.perf_counter()
    run.geom = sc.geometry(run.config, run.root)
    t_geom = time.perf_counter()
    api = sc.side(sc.PORT)
    built = sc.build(api, run.config, run.geom, run.device, run.root)
    sync(run.device)
    now = time.perf_counter()
    print(f"setup: imports and CUDA start {t - run.t0:.3f} s, geometry {t_geom - t:.3f} s, "
          f"the port's scene {now - t_geom:.3f} s", file=sys.stderr)
    return api, built
