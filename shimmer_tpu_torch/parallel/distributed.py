"""Rendering across processes with ``torch.distributed`` (port of
``shimmer_tpu/parallel/distributed.py``).

One process per host (or per card), joined by
``initialize_distributed``: NCCL between cards, gloo between CPU
processes.  The film's rows are split over the global mesh, every
process's local devices in rank order (``global_mesh``), and each
process renders its bands with the row-band renderer
(``parallel/render.py``, tiles mode): a wave needs no traffic between
processes.  The only collective of a render is the gather of the
resolved bands (``render_multihost``); a training step adds the
all-reduce of the gradient (``flagship.dryrun_multichip``).

Two CPU processes of four bands each:
``python -m shimmer_tpu_torch.experiments.dryrun_multihost``.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from shimmer_tpu_torch.config import resolve_device
from shimmer_tpu_torch.parallel.render import TileMesh, render_sharded


def _setting(given, *names):
    if given is not None:
        return given
    for name in names:
        if os.environ.get(name):
            return os.environ[name]
    return None


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None, process_id: int | None = None,
                           device=None) -> bool:
    """Join this process to the job; returns whether a job is set up.

    The arguments default to ``SHIMMER_COORDINATOR`` (``host:port``),
    ``SHIMMER_NUM_PROCESSES`` and ``SHIMMER_PROCESS_ID``, then to
    torchrun's ``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE`` and
    ``RANK``.  With none of them set this is a no-op (a one-process run);
    with some but not all it raises.  The group uses ``tcp://`` init,
    NCCL on the card (``device``, default the CUDA card, ``LOCAL_RANK``'s
    where torchrun sets it) and gloo only when ``device`` is the CPU.
    Calling it again once the group exists does nothing."""
    if dist.is_initialized():
        return True
    master = None
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        master = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    address = _setting(coordinator_address, "SHIMMER_COORDINATOR") or master
    world = _setting(num_processes, "SHIMMER_NUM_PROCESSES", "WORLD_SIZE")
    rank = _setting(process_id, "SHIMMER_PROCESS_ID", "RANK")
    if address is None and world is None and rank is None:
        return False
    if address is None or world is None or rank is None:
        raise ValueError(f"initialize_distributed: coordinator {address!r}, processes {world!r} "
                         f"and process id {rank!r}: all three are needed")
    if device is None and torch.cuda.is_available() and os.environ.get("LOCAL_RANK"):
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
    dist.init_process_group("gloo" if device.type == "cpu" else "nccl",
                            init_method=f"tcp://{address}", world_size=int(world),
                            rank=int(rank))
    return True


def _local_default():
    """This process's device: the CPU under gloo, else its CUDA card."""
    if dist.is_initialized() and dist.get_backend() == "gloo":
        return torch.device("cpu")
    resolve_device(None)  # raises without a card
    return torch.device("cuda", torch.cuda.current_device())


def global_mesh(devices=None, axis: str = "tiles") -> TileMesh:
    """The mesh over every process's bands: ``devices`` (default: this
    process's device, the CPU under gloo) are this process's, and process
    ``r`` of ``W`` owns bands ``r * L .. r * L + L - 1`` of ``W * L``.
    Without a process group it is the local mesh alone."""
    devices = tuple(torch.device(d) for d in (devices or [_local_default()]))
    if not dist.is_initialized():
        return TileMesh(devices, axis)
    return TileMesh(devices, axis, dist.get_rank(), dist.get_world_size())


def render_multihost(scene, camera, film, sampler, integrator: str = "path",
                     spp: int | None = None, max_depth: int = 5, wave_spp: int = 4,
                     devices=None):
    """Row-band render over the global mesh; every process calls it with
    the same scene and gets the whole (H, W, 3) image: each renders its
    bands (tiles mode), then the equal-sized band images are gathered
    with ``dist.all_gather`` in rank order."""
    mesh = global_mesh(devices)
    image, _ = render_sharded(scene, camera, film, sampler, mesh, integrator=integrator,
                              spp=spp, max_depth=max_depth, wave_spp=wave_spp, mode="tiles")
    if not dist.is_initialized():
        return image
    parts = [torch.empty_like(image) for _ in range(mesh.process_count)]
    dist.all_gather(parts, image.contiguous())
    return torch.cat(parts, dim=0)
