"""The flagship scene and the sharded training-step dry run (port of the
root's ``__graft_entry__.py``).

``flagship`` builds the Cornell-style box (five diffuse quads, a quad
area light) with a diffuse sphere; ``entry`` returns its forward wave
step; ``dryrun_multichip`` runs one sharded forward + gradient step
(d loss / d the reflectance table, through the megakernel) and one
sharded wavefront wave over a mesh of bands.

    python -m shimmer_tpu_torch.flagship [--device cpu] [--bands 8]

The two-process run is ``shimmer_tpu_torch/experiments/dryrun_multihost.py``.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from shimmer_tpu_torch.cameras import CameraTransform, PerspectiveCamera
from shimmer_tpu_torch.color.colorspace import get_named_color_space
from shimmer_tpu_torch.config import resolve_device
from shimmer_tpu_torch.film.film import PixelSensor, RgbFilm
from shimmer_tpu_torch.film.filters import BoxFilter
from shimmer_tpu_torch.lights import lights as lt
from shimmer_tpu_torch.materials import material as mtl
from shimmer_tpu_torch.ops.transform import Transform
from shimmer_tpu_torch.parallel.distributed import global_mesh
from shimmer_tpu_torch.parallel.render import (TileMesh, init_sharded_film_state,
                                               make_sharded_wave_renderer, make_tile_mesh,
                                               render_sharded)
from shimmer_tpu_torch.render import INTEGRATORS, full_image_pixels, render_pixel_samples
from shimmer_tpu_torch.samplers import IndependentSampler
from shimmer_tpu_torch.scene_builder import build_scene
from shimmer_tpu_torch.shapes.mesh import quad_mesh
from shimmer_tpu_torch.shapes.triangle import build_triangle_scene
from shimmer_tpu_torch.spectra.spectrum import ConstantSpectrum


def flagship(res=(32, 32), device=None):
    """(scene, camera, film) of the flagship scene at ``res`` (width,
    height), its tables on ``device`` (default: the CUDA card)."""
    device = resolve_device(device)
    cs = get_named_color_space("srgb")
    ct = CameraTransform(Transform.look_at([0.0, 1.0, 3.9], [0.0, 1.0, 0.0], [0.0, 1.0, 0.0]))
    cam = PerspectiveCamera(ct, res, fov=50.0)
    film = RgbFilm(res, BoxFilter(), PixelSensor(cs), cs)
    r2w = cam.camera_transform.render_from_world()
    w = 1.0
    meshes = [
        quad_mesh(r2w, [-w, 0, -w], [w, 0, -w], [w, 0, w], [-w, 0, w]).as_scene_dict(0),
        quad_mesh(r2w, [-w, 2, -w], [-w, 2, w], [w, 2, w], [w, 2, -w]).as_scene_dict(0),
        quad_mesh(r2w, [-w, 0, -w], [-w, 2, -w], [w, 2, -w], [w, 0, -w]).as_scene_dict(0),
        quad_mesh(r2w, [-w, 0, -w], [-w, 0, w], [-w, 2, w], [-w, 2, -w]).as_scene_dict(1),
        quad_mesh(r2w, [w, 0, -w], [w, 2, -w], [w, 2, w], [w, 0, w]).as_scene_dict(2),
        quad_mesh(r2w, [-0.3, 1.99, -0.3], [0.3, 1.99, -0.3], [0.3, 1.99, 0.3],
                  [-0.3, 1.99, 0.3]).as_scene_dict(3, area_light_id=np.array([0, 1], np.int32)),
    ]
    tris = build_triangle_scene(meshes, device=device)
    n_tri = int(tris.orig_indices.shape[0])
    scene = build_scene(
        tris,
        spheres=[{"radius": 0.45, "material_id": 0,
                  "object_to_world": Transform.translate([0.0, 0.45, 0.0])}],
        materials=[
            {"kind": mtl.DIFFUSE, "reflectance": [0.73, 0.73, 0.73]},
            {"kind": mtl.DIFFUSE, "reflectance": [0.65, 0.05, 0.05]},
            {"kind": mtl.DIFFUSE, "reflectance": [0.12, 0.45, 0.15]},
            {"kind": mtl.DIFFUSE, "reflectance": [0.0, 0.0, 0.0]},
        ],
        lights=[{"kind": lt.AREA, "spectrum": ConstantSpectrum(1.0), "scale": 25.0,
                 "shape_kind": lt.TRIANGLE_SHAPE, "shape_idx": n_tri - 2 + k} for k in range(2)],
        render_from_world=r2w,
        device=device,
    )
    return scene, cam, film


def entry(device=None):
    """The flagship's forward wave step (the megakernel over every pixel
    of a 32x32 film, depth 4) and example arguments:
    ``forward(film_state, sample_indices) -> film_state``."""
    scene, cam, film = flagship((32, 32), device)
    sampler = IndependentSampler(4)
    pixel_xy = full_image_pixels(film, scene.device)

    def forward(film_state, sample_indices):
        return render_pixel_samples(scene, cam, film, sampler, INTEGRATORS["path"], {},
                                    film_state, sample_indices, pixel_xy, max_depth=4)[0]

    return forward, (film.init_state(scene.device), torch.arange(2))


def reflectance_grad(mesh: TileMesh, res, all_reduce: bool = False):
    """One sharded training step on the flagship at ``res``: each band
    renders 1 sample a pixel through the megakernel (depth 3) into its
    own state; the loss is the sum of the bands' ``sum(rgb_sum) / (H *
    W)``.  Returns (loss, d loss / d reflectance table) on the mesh's first
    device.  The bands' losses are summed on the first device; with
    ``all_reduce`` (a job of several processes, each holding its bands of
    the global mesh) each process backpropagates its own, and the
    gradient and the loss are summed with ``dist.all_reduce``."""
    first = mesh.devices[0]
    scene, cam, film = flagship(res, first)
    refl = scene.materials.reflectance.detach().clone().requires_grad_(True)
    scene = dataclasses.replace(
        scene, materials=dataclasses.replace(scene.materials, reflectance=refl))
    wave = make_sharded_wave_renderer(scene, cam, film, IndependentSampler(2), mesh, "path",
                                      max_depth=3, mode="tiles", wavefront=False)
    states, _ = wave(init_sharded_film_state(film, mesh), torch.arange(1))
    n_px = res[0] * res[1]
    loss = None
    for s in states:
        band = (s.rgb_sum.sum() / n_px).to(first)
        loss = band if loss is None else loss + band
    (grad,) = torch.autograd.grad(loss, refl)
    loss = loss.detach()
    if all_reduce:
        dist.all_reduce(grad)
        dist.all_reduce(loss)
    return loss, grad


def dryrun_multichip(devices=None) -> dict:
    """One sharded forward + gradient step and one sharded wavefront wave
    over a mesh of ``devices`` (in a job of several processes: this
    process's bands of the global mesh; default: every local card).  The
    film is 16 x (8 x bands).  Raises unless the loss, the gradient and
    the wave's image are finite and nonzero; returns them with the two
    steps' seconds."""
    distributed = dist.is_initialized()
    mesh = global_mesh(devices) if distributed else make_tile_mesh(devices)
    res = (16, 8 * mesh.n_shards)
    seconds = []
    for _ in range(2):
        t0 = time.perf_counter()
        loss, grad = reflectance_grad(mesh, res, all_reduce=distributed)
        float(loss)
        seconds.append(time.perf_counter() - t0)
    print(f"dryrun_multichip: sharded fwd+bwd step on {mesh.n_shards} bands "
          f"({res[0] * res[1]} px): first {seconds[0]:.2f}s, second {seconds[1] * 1e3:.1f} ms")

    # The production integrator: one sharded wavefront wave on the same mesh.
    scene, cam, film = flagship(res, mesh.devices[0])
    img = render_sharded(scene, cam, film, IndependentSampler(2), mesh, spp=1, max_depth=3,
                         wave_spp=1)[0].cpu().numpy()
    g = grad.cpu().numpy()
    if not (np.isfinite(img).all() and img.mean() > 0):
        raise RuntimeError(f"dryrun_multichip: wavefront image mean {img.mean()}")
    if not np.isfinite(float(loss)):
        raise RuntimeError(f"dryrun_multichip: loss {float(loss)}")
    if g.shape != tuple(scene.materials.reflectance.shape) or not np.isfinite(g).all():
        raise RuntimeError(f"dryrun_multichip: gradient {g}")
    if not np.any(g != 0.0):
        raise RuntimeError("dryrun_multichip: gradient all zero")
    print(f"dryrun_multichip({mesh.n_shards}): loss={float(loss):.5f}, "
          f"|grad|={float(np.abs(g).sum()):.5f} - OK")
    return {"bands": mesh.n_shards, "resolution": list(res), "loss": float(loss), "grad": g,
            "step_seconds": seconds, "wave_image_mean": float(img.mean())}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--bands", type=int, default=None,
                    help="bands on the device (default: one a local card)")
    args = ap.parse_args()
    fn, example = entry(args.device)
    out = fn(*example)
    print("entry() ran:", tuple(out.rgb_sum.shape))
    dev = resolve_device(args.device)
    dryrun_multichip(None if args.bands is None and dev.type == "cuda"
                     else [dev] * (args.bands or 1))
