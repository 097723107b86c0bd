"""Command-line renderer (port of ``shimmer_tpu/cli.py``): parse a pbrt-v4
scene, render it on the CUDA card, write the image.

    python -m shimmer_tpu_torch.cli scene.pbrt -o out.pfm [--spp N] ...

``--device cpu`` renders with the plain torch versions on the CPU; there
is no silent fallback, so without a card and without ``--device cpu`` the
command raises.  ``--integrator`` picks the estimator (the scene's by
default) and ``--megakernel`` forces the masked megakernel in place of the
wavefront.  ``--checkpoint PATH`` saves the film state every
``--checkpoint-every`` waves and resumes from a matching checkpoint
there; ``--stats`` prints the statistics report after the render.
``--shard`` splits the film's rows over every local card (over one CPU
band with ``--device cpu``) through ``parallel.render.render_sharded``;
under ``torchrun`` (``WORLD_SIZE`` set) each process joins the job
(``parallel.distributed.initialize_distributed``: NCCL, its card the
``LOCAL_RANK``'s; gloo with ``--device cpu``), renders its band through
``render_multihost``, and rank 0 alone writes the image:

    torchrun --nproc-per-node 4 -m shimmer_tpu_torch.cli scene.pbrt --shard -o out.pfm

It keeps no checkpoint and no statistics, so with ``--checkpoint`` or
``--stats`` it raises, and it renders each band whole (no
``--pixel-block``).
"""

from __future__ import annotations

import argparse
import copy
import os
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="shimmer-tpu-torch",
                                 description="spectral path tracer on a CUDA card")
    ap.add_argument("scene", help="pbrt-v4 scene file")
    ap.add_argument("--outfile", "-o", default=None, help="output image (.pfm/.png)")
    ap.add_argument("--spp", type=int, default=None, help="override samples per pixel")
    ap.add_argument("--maxdepth", type=int, default=None)
    ap.add_argument("--integrator", default=None, choices=["path", "simplepath", "randomwalk"])
    ap.add_argument("--wave-spp", type=int, default=4)
    ap.add_argument("--pixel-block", type=int, default=1 << 15)
    ap.add_argument("--shard", action="store_true",
                    help="split the film's rows over every local card")
    ap.add_argument("--megakernel", action="store_true",
                    help="the masked megakernel instead of the wavefront integrator")
    ap.add_argument("--seed", type=int, default=None,
                    help="override the sampler's seed (default: the scene's)")
    ap.add_argument("--checkpoint", default=None, metavar="PATH",
                    help="save the film state every --checkpoint-every waves and resume "
                    "from PATH (bit-identical)")
    ap.add_argument("--checkpoint-every", type=int, default=1)
    ap.add_argument("--quiet", "-q", action="store_true")
    ap.add_argument("--stats", action="store_true",
                    help="print a statistics report after rendering")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback from one to the other")
    args = ap.parse_args(argv)
    if args.shard and (args.checkpoint or args.stats):
        raise NotImplementedError("--shard keeps no checkpoint and no statistics: "
                                  "drop --checkpoint and --stats, or --shard")

    from pathlib import Path

    import torch

    from shimmer_tpu_torch.film.image import Image
    from shimmer_tpu_torch.loading.parser import parse_file
    from shimmer_tpu_torch.loading.scene_builder import SceneBuilder
    from shimmer_tpu_torch.render import render

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA card is available; "
                           "pass --device cpu to render on the CPU")
    rank = None
    if args.shard and os.environ.get("WORLD_SIZE"):
        import torch.distributed as dist

        from shimmer_tpu_torch.parallel.distributed import initialize_distributed

        initialize_distributed(device=device if device.type == "cpu" else None)
        rank = dist.get_rank()
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())

    t0 = time.time()
    builder = SceneBuilder(search_dir=Path(args.scene).parent)
    parse_file(args.scene, builder)
    job = builder.create(device=device)
    if not args.quiet:
        print(f"scene build: {time.time() - t0:.2f}s", file=sys.stderr)

    spp = args.spp or job.spp
    sampler = job.sampler
    if args.seed is not None:
        # A sampler reads its seed only when it draws.
        sampler = copy.copy(sampler)
        sampler.seed = args.seed

    def progress(done, total):
        if not args.quiet:
            print(f"\r{done}/{total} spp", end="", file=sys.stderr, flush=True)

    t0 = time.time()
    common = dict(
        integrator=args.integrator or job.integrator, spp=spp,
        max_depth=args.maxdepth or job.max_depth, wave_spp=args.wave_spp, progress=progress,
        disable_pixel_jitter=job.disable_pixel_jitter,
        disable_wavelength_jitter=job.disable_wavelength_jitter,
        wavefront=False if args.megakernel else None,
    )
    if rank is not None:
        from shimmer_tpu_torch.parallel.distributed import render_multihost

        image = render_multihost(job.scene, job.camera, job.film, sampler, **common)
        dist.destroy_process_group()
        if rank != 0:
            return 0
    elif args.shard:
        from shimmer_tpu_torch.parallel.render import make_tile_mesh, render_sharded

        mesh = make_tile_mesh([device] if device.type == "cpu" else None)
        image = render_sharded(job.scene, job.camera, job.film, sampler, mesh, **common)[0]
    else:
        image = render(
            job.scene, job.camera, job.film, sampler, pixel_block=args.pixel_block,
            collect_stats=args.stats, checkpoint_path=args.checkpoint,
            checkpoint_every=args.checkpoint_every, **common,
        )[0]
    img = image.cpu().numpy()
    if not args.quiet:
        print(f"\nrender: {time.time() - t0:.2f}s", file=sys.stderr)
    out = args.outfile or job.filename
    Image(img).write(out)
    if not args.quiet:
        print(f"wrote {out}", file=sys.stderr)
    if args.stats:
        from shimmer_tpu_torch.utils import stats

        print(stats.report(), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
