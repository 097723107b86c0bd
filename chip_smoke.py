"""GPU smoke run of the PyTorch / CUDA port (shimmer_tpu_torch).

Drives the port's forward render path on one CUDA card at the bench
configuration (the scene of bench.py: 327,684 triangles, 1280x720, 16 spp,
depth 5, pixel blocks of 2^17 lanes, 16 samples per wave) and checks the
hand-written traversal kernel against its plain torch version on the card.

    python3 chip_smoke.py

Phases, each printing its own numbers:
  1. device: a CUDA card is required (no card -> exception, non-zero exit);
  2. build: the traversal kernel library from shimmer_tpu_torch/csrc;
  3. kernel against plain on the card: primary, bounce and merged
     wavefront batches on the full bench scene;
  4. a small render (64x48, 4 spp) on the card and on the CPU, compared;
  5. the full bench render through shimmer_tpu_torch.render.render.
No phase catches its own failure.  The last lines are the kernel table as
JSON, the card's name and power limit, and the result object.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

from shimmer_tpu_torch.bench_scene import (
    BENCH_RESOLUTION,
    BENCH_TRIS,
    bench_camera_film,
    build_bench_scene,
)
from shimmer_tpu_torch.ops import traverse as tv
from shimmer_tpu_torch.ops.sampling import sample_cosine_hemisphere
from shimmer_tpu_torch.ops.ray import offset_ray_origin
from shimmer_tpu_torch.render import pixel_blocks, render
from shimmer_tpu_torch.samplers import ZSobolSampler
from shimmer_tpu_torch.film.filters import get_camera_sample
from shimmer_tpu_torch.shapes.triangle import (
    _A_P0,
    intersect_triangle,
    triangle_interaction_from_raw,
)

BLOCK = 1 << 17
SPP = 16
WAVE_SPP = 16
MAX_DEPTH = 5
SMALL_RES = (64, 48)
SMALL_SPP = 4
# Image agreement between two renders of the same seeds (the CPU tests use
# the same criteria against the JAX reference): at least 99% of pixels
# within rtol 1e-3 / atol 1e-4 and image means within 1e-3 relative.  The
# margin covers a path that branches differently on a last-ulp difference
# of a transcendental (CUDA and CPU math libraries differ there) and the
# run-to-run order of the film's atomic scatter-add.
PIXEL_RTOL, PIXEL_ATOL, PIXEL_FRAC, MEAN_RTOL = 1e-3, 1e-4, 0.99, 1e-3


def log(msg):
    print(msg, flush=True)


def check(ok, msg: str):
    """A failed check ends the run (kept under python -O, unlike assert)."""
    if not ok:
        raise RuntimeError(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare_traversal(tris, o, d, t_max, any_hit, name: str) -> dict:
    """Kernel (traverse_raw on CUDA tensors) against traverse_raw_plain on
    the same tensors: equal hit masks, bit-equal t where both hit, equal
    tri except at exact t ties (closest-hit lanes), equal occlusion bits
    (any-hit lanes), and no lane where the kernel hits but the torch
    re-intersection of its triangle misses."""
    n = o.shape[0]
    want = torch.broadcast_to(torch.as_tensor(any_hit, device=o.device), (n,))
    t_k, tri_k, steps = tv.traverse_raw(tris, o, d, t_max, any_hit=want, return_steps=True)
    t_p, tri_p = tv.traverse_raw_plain(tris.rows8, tris.stack_depth, o, d, t_max, want)
    torch.cuda.synchronize()
    hit_k, hit_p = tri_k >= 0, tri_p >= 0
    check(bool((hit_k == hit_p).all()), f"{name}: hit masks differ")
    closest = hit_k & ~want
    t_equal = t_k[closest] == t_p[closest]
    check(bool(t_equal.all()), f"{name}: t differs on {int((~t_equal).sum())} lanes")
    tri_diff = closest & (tri_k != tri_p)
    # A tri mismatch is allowed only where both triangles give the same t.
    attr = tris.attr_rows[torch.clamp(tri_p, min=0).long()]
    _, t_alt, *_ = intersect_triangle(
        o, d, torch.full_like(t_max, float("inf")),
        attr[:, _A_P0:_A_P0 + 3], attr[:, _A_P0 + 3:_A_P0 + 6], attr[:, _A_P0 + 6:_A_P0 + 9],
    )
    check(bool((t_alt[tri_diff] == t_k[tri_diff]).all()), f"{name}: tri differs off a tie")
    max_err = float((t_k[closest] - t_p[closest]).abs().max()) if bool(closest.any()) else 0.0
    # A kernel hit whose torch re-intersection misses would reach shading
    # as tri >= 0 with t = inf.
    si = triangle_interaction_from_raw(tris, o, d, tri_k)
    rehit_miss = int((hit_k & torch.isinf(si.t)).sum())
    check(rehit_miss == 0, f"{name}: {rehit_miss} kernel hits miss on re-intersection")

    sorted_args = _sorted_layout(tris, o, d, t_max, want)
    kernel_ms = cuda_ms(lambda: tv._launch_kernel(*sorted_args, False), reps=10)
    wrapper_ms = cuda_ms(lambda: tv.traverse_raw(tris, o, d, t_max, any_hit=want), reps=10)
    plain_ms = cuda_ms(
        lambda: tv.traverse_raw_plain(tris.rows8, tris.stack_depth, o, d, t_max, want), reps=2
    )
    live = t_max > 0
    res = {
        "batch": name,
        "rays": n,
        "live": int(live.sum()),
        "hits": int(hit_k.sum()),
        "tri_ties": int(tri_diff.sum()),
        "rehit_miss": rehit_miss,
        "max_abs_err_t": max_err,
        "kernel_ms": round(kernel_ms, 4),
        "wrapper_ms": round(wrapper_ms, 4),
        "plain_ms": round(plain_ms, 4),
        "steps_per_live_ray": round(float(steps[live].float().mean()), 3),
    }
    log(f"phase 3 {name}: {json.dumps(res)}")
    return res


def _sorted_layout(tris, o, d, t_max, want):
    """The kernel's inputs as traverse_raw lays them out (sorted rays)."""
    order = tv.ray_order(tris, o, d, t_max, want)
    return (tris.rows8, tris.meta, tris.stack_depth, o[order].contiguous(),
            d[order].contiguous(), t_max[order].contiguous(), want[order].contiguous())


def primary_rays(cam, film, sampler, pixel_xy, dev):
    s = sampler.start_pixel_sample(pixel_xy, 0)
    _, s = sampler.get_1d(s)
    u_f, s = sampler.get_pixel_2d(s)
    u_l, s = sampler.get_2d(s)
    p_film, _, u_l = get_camera_sample(film.filter, pixel_xy, u_f, u_l)
    ray = cam.generate_ray(p_film, u_l)
    return ray.o.contiguous(), ray.d.contiguous(), s


def phase3(scene, cam, film, dev) -> list[dict]:
    tris = scene.triangles
    sampler = ZSobolSampler(SPP, film.resolution)
    blocks, _ = pixel_blocks(film, BLOCK, dev)
    px = blocks[0]
    inf = torch.full((BLOCK,), float("inf"), device=dev)
    o, d, s_state = primary_rays(cam, film, sampler, px, dev)
    results = [compare_traversal(tris, o, d, inf, False, "primary")]

    # Bounce rays: cosine-hemisphere directions around the shading normal
    # of the primary hits (missed lanes borrow a hit lane's point).
    _, tri = tv.traverse_raw(tris, o, d, inf)
    hit_lanes = torch.nonzero(tri >= 0).squeeze(1)
    src = hit_lanes[torch.arange(BLOCK, device=dev) % hit_lanes.numel()]
    si = triangle_interaction_from_raw(tris, o[src], d[src], tri[src])
    frame = si.shading_frame()
    u2, _ = sampler.get_2d(s_state)
    wi = frame.from_local(sample_cosine_hemisphere(u2))
    bo = offset_ray_origin(si.p, si.n, wi).contiguous()
    bd = wi.contiguous()
    results.append(compare_traversal(tris, bo, bd, inf, False, "bounce"))

    # Merged wavefront launch: extension rays, then shadow rays toward
    # points on the light quad (any hit, t_max just short of the light),
    # with about half the lanes of each half dead (t_max = -inf).
    rng = np.random.default_rng(0)
    lq = scene.triangles.light_rows[-2:, 0:9].reshape(2, 3, 3)
    bary = torch.from_numpy(rng.dirichlet([1.0, 1.0, 1.0], BLOCK).astype(np.float32)).to(dev)
    which = torch.from_numpy(rng.integers(0, 2, BLOCK)).to(dev)
    target = torch.einsum("nk,nkc->nc", bary, lq[which])
    sh_d = (target - bo).contiguous()
    dead = torch.from_numpy(rng.random(2 * BLOCK) < 0.5).to(dev)
    t_ext = torch.where(dead[:BLOCK], -float("inf"), float("inf"))
    t_sh = torch.where(dead[BLOCK:], -float("inf"), 1.0 - 1e-3)
    mo = torch.cat([bo, bo]).contiguous()
    md = torch.cat([bd, sh_d]).contiguous()
    mt = torch.cat([t_ext, t_sh]).contiguous()
    want = torch.arange(2 * BLOCK, device=dev) >= BLOCK
    results.append(compare_traversal(tris, mo, md, mt, want, "merged"))
    return results


def image_agreement(a: np.ndarray, b: np.ndarray) -> dict:
    close = np.isclose(a, b, rtol=PIXEL_RTOL, atol=PIXEL_ATOL).all(axis=-1)
    mean_a, mean_b = float(a.mean()), float(b.mean())
    return {
        "frac_pixels_close": float(close.mean()),
        "mean_a": mean_a,
        "mean_b": mean_b,
        "mean_rel_diff": abs(mean_a - mean_b) / max(abs(mean_b), 1e-12),
    }


def phase4(scene_cpu, scene_gpu) -> dict:
    cam, film = bench_camera_film(SMALL_RES)
    images = {}
    seconds = {}
    for name, scene in (("gpu", scene_gpu), ("cpu", scene_cpu)):
        sampler = ZSobolSampler(SMALL_SPP, SMALL_RES)
        t0 = time.perf_counter()
        img, _, _ = render(scene, cam, film, sampler, spp=SMALL_SPP, max_depth=MAX_DEPTH,
                           wave_spp=SMALL_SPP, pixel_block=BLOCK)
        images[name] = img.cpu().numpy()
        seconds[name] = time.perf_counter() - t0
    for name, img in images.items():
        check(np.isfinite(img).all() and img.mean() > 0, f"phase 4: bad {name} image")
    agree = image_agreement(images["gpu"], images["cpu"])
    log(f"phase 4 small render {SMALL_RES[0]}x{SMALL_RES[1]} spp {SMALL_SPP}: "
        f"gpu {seconds['gpu']:.2f}s cpu {seconds['cpu']:.2f}s {json.dumps(agree)}")
    check(agree["frac_pixels_close"] >= PIXEL_FRAC, "phase 4: images differ")
    check(agree["mean_rel_diff"] <= MEAN_RTOL, "phase 4: image means differ")
    return agree


def phase5(scene_gpu) -> dict:
    cam, film = bench_camera_film(BENCH_RESOLUTION)
    sampler = ZSobolSampler(SPP, BENCH_RESOLUTION)
    n_blocks = -(-BENCH_RESOLUTION[0] * BENCH_RESOLUTION[1] // BLOCK)
    tv.traverse_raw.kernel_launches = 0
    tv.traverse_raw_plain.calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img, _, stats = render(scene_gpu, cam, film, sampler, spp=SPP, max_depth=MAX_DEPTH,
                           wave_spp=WAVE_SPP, pixel_block=BLOCK)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = tv.traverse_raw.kernel_launches
    plain_calls = tv.traverse_raw_plain.calls
    img = img.cpu().numpy()
    check(np.isfinite(img).all(), "phase 5: non-finite image")
    check(img.mean() > 0, "phase 5: black image")
    check(launches > 0, "phase 5: the render did not launch the kernel")
    check(plain_calls == 0, "phase 5: the plain traversal ran on the card")
    waves = -(-SPP // WAVE_SPP)
    res = {
        "seconds": round(seconds, 3),
        "rays": stats["rays"],
        "mrays_per_s": round(stats["rays"] / seconds / 1e6, 4),
        "iters_per_wave": round(stats["iters"] / waves, 2),
        "iters_per_block_wave": round(stats["iters"] / (waves * n_blocks), 2),
        "lane_occupancy": round(stats["rays"] / (stats["iters"] * 2 * BLOCK), 4),
        "image_mean": float(img.mean()),
        "kernel_launches": launches,
        "plain_calls": plain_calls,
    }
    log(f"phase 5 full render {BENCH_RESOLUTION[0]}x{BENCH_RESOLUTION[1]} spp {SPP}: {json.dumps(res)}")
    return res


def main():
    # 1. device
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card; none is available")
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    log(f"phase 1 device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; {smi}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    build = tv.build_library(force=True)
    ptx = [ln.strip() for ln in build["log"].splitlines() if "registers" in ln or "spill" in ln]
    log(f"phase 2 build: {build['seconds']:.2f}s; {' | '.join(ptx)}")

    # The bench scene: tables built once on the host, copied to the card.
    t0 = time.perf_counter()
    scene_cpu, cam, film = build_bench_scene(BENCH_TRIS, BENCH_RESOLUTION, device="cpu")
    scene_gpu = scene_cpu.to(dev)
    tris = scene_gpu.triangles
    log(f"scene: {tris.orig_indices.shape[0]} triangles, {tris.rows8.shape[0]} BVH8 rows, "
        f"stack depth {tris.stack_depth}, built in {time.perf_counter() - t0:.1f}s")

    # 3. kernel against plain on the card
    batches = phase3(scene_gpu, cam, film, dev)
    # 4. small render, card against CPU
    phase4(scene_cpu, scene_gpu)
    # 5. the full bench render through the port's entry point
    full = phase5(scene_gpu)

    merged = batches[-1]
    kernels = {
        "kernels": [
            {
                "name": "bvh8_traverse",
                "route": "cuda",
                "source": "shimmer_tpu_torch/csrc/traverse.cu",
                "replaces": "shimmer_tpu/ops/pallas/traverse.py:124",
                "launches": full["kernel_launches"],
                "max_abs_err": max(b["max_abs_err_t"] for b in batches),
                "ms": merged["kernel_ms"],
                "plain_ms": merged["plain_ms"],
            }
        ]
    }
    print(json.dumps(kernels), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
