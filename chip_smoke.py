"""GPU smoke run of the PyTorch / CUDA port (shimmer_tpu_torch).

Drives the port's forward render path on one CUDA card at the bench
configuration (the scene of bench.py: 327,684 triangles, 1280x720, 16 spp,
depth 5, pixel blocks of 2^17 lanes, 16 samples per wave) under every
traversal configuration, and the 1.3M-triangle leg of bench.py, and checks
each hand-written traversal kernel against its plain torch version on the
card.

    python3 chip_smoke.py

Phases, each printing its own numbers:
  1. device: a CUDA card is required (no card -> exception, non-zero exit);
  2. build: the traversal kernel library from shimmer_tpu_torch/csrc (one
     nvcc run), and the native SAH BVH builder (g++), which must load: the
     scenes' tables are built with it;
  3. each traversal configuration (v1, v2, v1 with Moller-Trumbore leaves,
     v1 with the min-id winner, and the combined v1 MT + min-id) against
     the plain version on the card: primary, bounce and merged wavefront
     batches on the full bench scene;
  4. a small render (64x48, 4 spp) on the card and on the CPU under each
     configuration, compared;
  5. the full bench render under v1 through shimmer_tpu_torch.render.render;
  6. the full bench render under v2, v1 with MT leaves and v1 with the
     min-id winner, each compared with the v1 image;
  7. the 1.3M-triangle leg: v1 and v2 against the plain version on one
     merged batch, then pixel-block waves 0-2 rendered under v1 and v2.
Launch counters are set to 0 just before each render path and read just
after it.  No phase catches its own failure.  The last lines are the kernel
table as JSON, the card's name and power limit, and the result object.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import time

import numpy as np
import torch

from shimmer_tpu_torch import native
from shimmer_tpu_torch.bench_scene import (
    BENCH_RESOLUTION,
    BENCH_TRIS,
    LARGE_TRIS,
    bench_camera_film,
    build_bench_scene,
)
from shimmer_tpu_torch.film.filters import get_camera_sample
from shimmer_tpu_torch.ops import traverse as tv
from shimmer_tpu_torch.ops.ray import offset_ray_origin
from shimmer_tpu_torch.ops.sampling import sample_cosine_hemisphere
from shimmer_tpu_torch.ops.traverse import TraverseConfig
from shimmer_tpu_torch.render import make_wavefront_renderer, pixel_blocks, render
from shimmer_tpu_torch.samplers import ZSobolSampler
from shimmer_tpu_torch.shapes.triangle import (
    _A_P0,
    intersect_triangle,
    intersect_triangle_mt,
    triangle_interaction_from_raw,
)

BLOCK = 1 << 17
SPP = 16
WAVE_SPP = 16
MAX_DEPTH = 5
SMALL_RES = (64, 48)
SMALL_SPP = 4
LARGE_BLOCK_WAVES = 3
# Image agreement between two renders of the same seeds (the CPU tests use
# the same criteria against the JAX reference): at least 99% of pixels
# within rtol 1e-3 / atol 1e-4 and image means within 1e-3 relative.  The
# margin covers a path that branches differently on a last-ulp difference
# of a transcendental (CUDA and CPU math libraries differ there), a tie
# between two triangles at the same t that another traversal order breaks
# the other way, and the run-to-run order of the film's atomic scatter-add.
PIXEL_RTOL, PIXEL_ATOL, PIXEL_FRAC, MEAN_RTOL = 1e-3, 1e-4, 0.99, 1e-3
# The traversal configurations on the render path, by launch-counter name.
CONFIGS = {
    "v1": TraverseConfig("v1", "watertight", "slot"),
    "v2": TraverseConfig("v2", "watertight", "slot"),
    "v1_mt": TraverseConfig("v1", "mt", "slot"),
    "v1_min": TraverseConfig("v1", "watertight", "min"),
}
# The combined form the configuration allows, held to the plain version in
# phase 3 only (the reference never rendered with it).
COMBINED_CONFIGS = {
    "v1_mt_min": TraverseConfig("v1", "mt", "min"),
}
# The least time of a traversal launch: the larger of bytes over the HBM
# rate and float32 operations over the non-tensor-core float32 peak
# (NVIDIA H100 SXM data sheet rates).  Bytes: each input read once and
# each output written once, counting only the table entries these rays
# read (the kernel's own `touched` record of one launch): per internal row
# visited its 6 box-coordinate and 1 valid-flag groups of 8 floats, per
# leaf row visited its 9 vertex-coordinate groups (the id group, read only
# on a hit, is left out), per meta word read 4 bytes; plus the rays.
# Operations: the kernel's own per-ray visit counts at 208 a visit (the
# slab test of 8 child boxes, 26 each; a leaf visit of 8 triangles costs
# more, so this is a lower bound).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
OPS_PER_VISIT = 8 * 26
INTERNAL_ROW_BYTES = 7 * 8 * 4
LEAF_ROW_BYTES = 9 * 8 * 4
RAY_BYTES_IN = 12 + 12 + 4 + 1    # o, d, t_max, any-hit flag
RAY_BYTES_OUT = 4 + 4             # t, tri
# Kernel-table rows (PERF.md) -> (configuration, source).
KERNEL_ROWS = {
    "bvh8_traverse_v1": ("v1", "shimmer_tpu_torch/csrc/traverse.cu",
                         "shimmer_tpu/ops/pallas/traverse.py:124"),
    "bvh8_traverse_v1_large_table": ("v1", "shimmer_tpu_torch/csrc/traverse.cu",
                                     "shimmer_tpu/ops/pallas/traverse.py:137"),
    "bvh8_traverse_v1_mt_leaves": ("v1_mt", "shimmer_tpu_torch/csrc/traverse.cu",
                                   "shimmer_tpu/ops/pallas/traverse.py:228"),
    "bvh8_traverse_v1_min_winner": ("v1_min", "shimmer_tpu_torch/csrc/traverse.cu",
                                    "shimmer_tpu/ops/pallas/traverse.py:295"),
    "bvh8_traverse_v2": ("v2", "shimmer_tpu_torch/csrc/traverse.cu",
                         "shimmer_tpu/ops/pallas/traverse.py:456"),
}


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


def reset_counts():
    tv.traverse_raw.launches = dict.fromkeys(tv.KERNEL_NAMES, 0)
    tv.traverse_raw_plain.calls = 0


def read_counts(name: str, expect: str) -> int:
    """The launches of kernel ``expect`` since reset_counts(); fails unless
    it launched, nothing else launched and the plain version never ran."""
    launches = dict(tv.traverse_raw.launches)
    check(launches[expect] > 0, f"{name}: the {expect} kernel was not launched")
    others = {k: v for k, v in launches.items() if k != expect and v}
    check(not others, f"{name}: other kernels launched: {others}")
    check(tv.traverse_raw_plain.calls == 0, f"{name}: the plain traversal ran on the card")
    return launches[expect]


def winner_t(tris, o, d, tri):
    """t of triangle ``tri`` per ray under the table's own leaf test."""
    attr = tris.attr_rows[torch.clamp(tri, min=0).long()]
    p0, p1, p2 = (attr[:, _A_P0 + 3 * k:_A_P0 + 3 * k + 3] for k in range(3))
    inf = torch.full((o.shape[0],), float("inf"), device=o.device)
    if tris.traverse.leaf == "mt":
        return intersect_triangle_mt(o, d, inf, p0, p1 - p0, p2 - p0)[1]
    return intersect_triangle(o, d, inf, p0, p1, p2)[1]


def bound(tris, touched, n_rays: int, visits: int) -> dict:
    """The bound of one traversal launch (see HBM_BYTES_PER_S) from the
    launch's ``touched`` record: bound_ms, bound_by and the work counted."""
    n_rows = tris.meta.shape[0]
    rows = touched[:n_rows].bool()
    leaf = (tris.meta & 15) > 0
    work = {
        "internal_rows_read": int((rows & ~leaf).sum()),
        "leaf_rows_read": int((rows & leaf).sum()),
        "meta_words_read": int(touched[n_rows:].sum()),
    }
    work["bytes"] = (work["internal_rows_read"] * INTERNAL_ROW_BYTES
                     + work["leaf_rows_read"] * LEAF_ROW_BYTES + work["meta_words_read"] * 4
                     + n_rays * (RAY_BYTES_IN + RAY_BYTES_OUT))
    t_bytes = work["bytes"] / HBM_BYTES_PER_S
    t_ops = visits * OPS_PER_VISIT / FP32_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", **work}


def compare_traversal(tris, o, d, t_max, any_hit, name: str, plain=None) -> dict:
    """The kernel of ``tris.traverse`` (traverse_raw on CUDA tensors)
    against traverse_raw_plain on the same tensors: equal hit masks (so
    equal occlusion bits on any-hit lanes), bit-equal t where both hit,
    equal tri except at exact t ties.  Counts the closest-hit lanes whose
    watertight re-intersection misses the kernel's winner (0 for
    watertight leaves) and checks that the interaction turns each into a
    miss."""
    cfg = tris.traverse
    n = o.shape[0]
    want = torch.broadcast_to(torch.as_tensor(any_hit, device=o.device), (n,))
    t_k, tri_k, steps = tv.traverse_raw(tris, o, d, t_max, any_hit=want, return_steps=True)
    if plain is None:
        plain = tv.traverse_raw_plain(tris.rows8, tris.stack_depth, o, d, t_max, want,
                                      leaf=cfg.leaf, winner=cfg.winner)
    t_p, tri_p = plain
    torch.cuda.synchronize()
    hit_k, hit_p = tri_k >= 0, tri_p >= 0
    check(bool((hit_k == hit_p).all()), f"{name}: hit masks differ")
    closest = hit_k & ~want
    t_equal = t_k[closest] == t_p[closest]
    check(bool(t_equal.all()), f"{name}: t differs on {int((~t_equal).sum())} lanes")
    tri_diff = closest & (tri_k != tri_p)
    # A tri mismatch is allowed only where both triangles give the same t.
    t_alt = winner_t(tris, o, d, tri_p)
    check(bool((t_alt[tri_diff] == t_k[tri_diff]).all()), f"{name}: tri differs off a tie")
    max_err = float((t_k[closest] - t_p[closest]).abs().max()) if bool(closest.any()) else 0.0
    # Closest-hit winners whose watertight re-intersection misses: each
    # must reach shading as a miss, never as tri >= 0 with t = inf.
    attr = tris.attr_rows[torch.clamp(tri_k, min=0).long()]
    rehit, *_ = intersect_triangle(
        o, d, torch.full_like(t_max, float("inf")),
        attr[:, _A_P0:_A_P0 + 3], attr[:, _A_P0 + 3:_A_P0 + 6], attr[:, _A_P0 + 6:_A_P0 + 9],
    )
    rehit_miss = closest & ~rehit
    si = triangle_interaction_from_raw(tris, o, d, torch.where(want, -1, tri_k))
    check(bool((si.valid == (closest & rehit)).all()), f"{name}: interaction validity")
    check(not bool((si.valid & torch.isinf(si.t)).any()), f"{name}: a valid hit with t = inf")
    check(cfg.leaf == "mt" or int(rehit_miss.sum()) == 0,
          f"{name}: {int(rehit_miss.sum())} watertight kernel hits miss on re-intersection")

    sorted_args = _sorted_layout(tris, o, d, t_max, want)
    touched = torch.zeros(2 * tris.meta.shape[0], dtype=torch.uint8, device=o.device)
    tv._launch_kernel(*sorted_args, False, cfg, touched=touched)
    kernel_ms = cuda_ms(lambda: tv._launch_kernel(*sorted_args, False, cfg), reps=10)
    wrapper_ms = cuda_ms(lambda: tv.traverse_raw(tris, o, d, t_max, any_hit=want), reps=10)
    plain_ms = cuda_ms(
        lambda: tv.traverse_raw_plain(tris.rows8, tris.stack_depth, o, d, t_max, want,
                                      leaf=cfg.leaf, winner=cfg.winner), reps=2
    )
    live = t_max > 0
    visits = int(steps.sum())
    res = {
        "kernel": cfg.name,
        "batch": name,
        "rays": n,
        "live": int(live.sum()),
        "hits": int(hit_k.sum()),
        "tri_ties": int(tri_diff.sum()),
        "anyhit_mismatch": int((hit_k != hit_p)[want].sum()),
        "rehit_miss": int(rehit_miss.sum()),
        "max_abs_err_t": max_err,
        "kernel_ms": kernel_ms,
        "wrapper_ms": wrapper_ms,
        "plain_ms": plain_ms,
        "visits": visits,
        "steps_per_live_ray": float(steps[live].float().mean()),
        **bound(tris, touched, n, visits),
    }
    log(f"phase 3 {cfg.name} {name}: {json.dumps(res)}")
    return res


def _sorted_layout(tris, o, d, t_max, want):
    """The kernel's inputs as traverse_raw lays them out (sorted rays)."""
    order = tv.ray_order(tris, o, d, t_max, want)
    return (tris.rows8, tris.meta, tris.stack_depth, o[order].contiguous(),
            d[order].contiguous(), t_max[order].contiguous(), want[order].contiguous())


def primary_rays(cam, film, sampler, pixel_xy):
    s = sampler.start_pixel_sample(pixel_xy, 0)
    _, s = sampler.get_1d(s)
    u_f, s = sampler.get_pixel_2d(s)
    u_l, s = sampler.get_2d(s)
    p_film, _, u_l = get_camera_sample(film.filter, pixel_xy, u_f, u_l)
    ray = cam.generate_ray(p_film, u_l)
    return ray.o.contiguous(), ray.d.contiguous(), s


def bench_batches(scene, cam, film, dev) -> dict:
    """The three traversal batches of the first pixel block: primary,
    bounce and the merged wavefront launch, as (o, d, t_max, any_hit)."""
    tris = scene.triangles.with_traverse(CONFIGS["v1"])
    sampler = ZSobolSampler(SPP, film.resolution)
    blocks, _ = pixel_blocks(film, BLOCK, dev)
    inf = torch.full((BLOCK,), float("inf"), device=dev)
    o, d, s_state = primary_rays(cam, film, sampler, blocks[0])

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

    # Merged wavefront launch: extension rays, then shadow rays toward
    # points on the light quad (any hit, t_max just short of the light),
    # with about half the lanes of each half dead (t_max = -inf).
    rng = np.random.default_rng(0)
    lq = tris.light_rows[-2:, 0:9].reshape(2, 3, 3)
    bary = torch.from_numpy(rng.dirichlet([1.0, 1.0, 1.0], BLOCK).astype(np.float32)).to(dev)
    which = torch.from_numpy(rng.integers(0, 2, BLOCK)).to(dev)
    target = torch.einsum("nk,nkc->nc", bary, lq[which])
    sh_d = (target - bo).contiguous()
    dead = torch.from_numpy(rng.random(2 * BLOCK) < 0.5).to(dev)
    t_ext = torch.where(dead[:BLOCK], -float("inf"), float("inf"))
    t_sh = torch.where(dead[BLOCK:], -float("inf"), 1.0 - 1e-3)
    merged = (
        torch.cat([bo, bo]).contiguous(), torch.cat([bd, sh_d]).contiguous(),
        torch.cat([t_ext, t_sh]).contiguous(), torch.arange(2 * BLOCK, device=dev) >= BLOCK,
    )
    return {
        "primary": (o, d, inf, False),
        "bounce": (bo, bd, inf, False),
        "merged": merged,
    }


def phase3(scene, batches) -> dict:
    results = {}
    for name, cfg in {**CONFIGS, **COMBINED_CONFIGS}.items():
        tris = scene.triangles.with_traverse(cfg)
        results[name] = [compare_traversal(tris, *batch, bname) for bname, batch in batches.items()]
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


def check_agreement(name: str, a: np.ndarray, b: np.ndarray) -> dict:
    agree = image_agreement(a, b)
    check(agree["frac_pixels_close"] >= PIXEL_FRAC, f"{name}: images differ")
    check(agree["mean_rel_diff"] <= MEAN_RTOL, f"{name}: image means differ")
    return agree


def with_config(scene, name):
    return dataclasses.replace(scene, triangles=scene.triangles.with_traverse(CONFIGS[name]))


def phase4(scene_cpu, scene_gpu) -> dict:
    cam, film = bench_camera_film(SMALL_RES)
    cpu_images = {}
    out = {}
    for name, cfg in CONFIGS.items():
        images, seconds = {}, {}
        # The CPU runs the plain version, which v1 and v2 share.
        cpu_key = (cfg.leaf, cfg.winner)
        targets = [("gpu", scene_gpu)] + ([("cpu", scene_cpu)] if cpu_key not in cpu_images else [])
        for dev_name, scene in targets:
            sampler = ZSobolSampler(SMALL_SPP, SMALL_RES)
            t0 = time.perf_counter()
            img, _, _ = render(with_config(scene, name), cam, film, sampler, spp=SMALL_SPP,
                               max_depth=MAX_DEPTH, wave_spp=SMALL_SPP, pixel_block=BLOCK)
            images[dev_name] = img.cpu().numpy()
            seconds[dev_name] = time.perf_counter() - t0
        if "cpu" in images:
            cpu_images[cpu_key] = images["cpu"]
        images["cpu"] = cpu_images[cpu_key]
        for dev_name, img in images.items():
            check(np.isfinite(img).all() and img.mean() > 0, f"phase 4 {name}: bad {dev_name} image")
        agree = check_agreement(f"phase 4 {name}", images["gpu"], images["cpu"])
        log(f"phase 4 {name} small render {SMALL_RES[0]}x{SMALL_RES[1]} spp {SMALL_SPP}: "
            f"seconds {json.dumps(seconds)} {json.dumps(agree)}")
        out[name] = agree
    return out


def full_render(scene_gpu, name: str, phase: str) -> tuple[dict, np.ndarray]:
    """The full bench render under configuration ``name``; its launches
    are counted from 0."""
    cam, film = bench_camera_film(BENCH_RESOLUTION)
    sampler = ZSobolSampler(SPP, BENCH_RESOLUTION)
    n_blocks = -(-BENCH_RESOLUTION[0] * BENCH_RESOLUTION[1] // BLOCK)
    scene = with_config(scene_gpu, name)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    img, _, stats = render(scene, cam, film, sampler, spp=SPP, max_depth=MAX_DEPTH,
                           wave_spp=WAVE_SPP, pixel_block=BLOCK)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts(f"{phase} {name}", name)
    img = img.cpu().numpy()
    check(np.isfinite(img).all(), f"{phase} {name}: non-finite image")
    check(img.mean() > 0, f"{phase} {name}: black image")
    waves = -(-SPP // WAVE_SPP)
    res = {
        "kernel": name,
        "seconds": seconds,
        "rays": stats["rays"],
        "mrays_per_s": stats["rays"] / seconds / 1e6,
        "iters": stats["iters"],
        "iters_per_block_wave": stats["iters"] / (waves * n_blocks),
        "lane_occupancy": stats["rays"] / (stats["iters"] * 2 * BLOCK),
        "image_mean": float(img.mean()),
        "kernel_launches": launches,
    }
    return res, img


def phase5(scene_gpu) -> tuple[dict, np.ndarray]:
    res, img = full_render(scene_gpu, "v1", "phase 5")
    log(f"phase 5 full render {BENCH_RESOLUTION[0]}x{BENCH_RESOLUTION[1]} spp {SPP}: "
        f"{json.dumps(res)}")
    return res, img


def phase6(scene_gpu, v1_img) -> dict:
    out = {}
    for name in ("v2", "v1_mt", "v1_min"):
        res, img = full_render(scene_gpu, name, "phase 6")
        res["vs_v1"] = check_agreement(f"phase 6 {name}", img, v1_img)
        log(f"phase 6 full render {name}: {json.dumps(res)}")
        out[name] = res
    return out


def phase7(dev) -> dict:
    t0 = time.perf_counter()
    scene_cpu, cam, film = build_bench_scene(LARGE_TRIS, BENCH_RESOLUTION, device="cpu")
    build_s = time.perf_counter() - t0
    scene = scene_cpu.to(dev)
    del scene_cpu
    tris = scene.triangles
    table_bytes = tris.rows8.numel() * 4 + tris.meta.numel() * 4
    log(f"phase 7 scene: {tris.orig_indices.shape[0]} triangles, {tris.rows8.shape[0]} BVH8 rows, "
        f"table {table_bytes} bytes, stack depth {tris.stack_depth}, host build {build_s:.1f}s")
    merged = bench_batches(scene, cam, film, dev)["merged"]
    o, d, t_max, want = merged
    plain = tv.traverse_raw_plain(tris.rows8, tris.stack_depth, o, d, t_max, want)
    compares = {
        name: compare_traversal(with_config(scene, name).triangles, *merged, "large merged",
                                plain=plain)
        for name in ("v1", "v2")
    }

    sampler = ZSobolSampler(WAVE_SPP, BENCH_RESOLUTION)
    blocks, valids = pixel_blocks(film, BLOCK, dev)
    idx = torch.arange(WAVE_SPP, dtype=torch.int64, device=dev)
    renders = {}
    for name in ("v1", "v2"):
        wave_fn = make_wavefront_renderer(with_config(scene, name), cam, film, sampler,
                                          max_depth=MAX_DEPTH)
        state = film.init_state(dev)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        rays = 0.0
        for b in range(LARGE_BLOCK_WAVES):
            state, st = wave_fn(state, idx, blocks[b], valids[b])
            rays += float(st["rays"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts(f"phase 7 {name}", name)
        img = film.get_image(state).cpu().numpy()
        check(np.isfinite(img).all() and img.mean() > 0, f"phase 7 {name}: bad image")
        renders[name] = {
            "block_waves": LARGE_BLOCK_WAVES,
            "seconds": seconds,
            "rays": rays,
            "mrays_per_s": rays / seconds / 1e6,
            "kernel_launches": launches,
            "image_mean": float(img.mean()),
        }
        log(f"phase 7 {name} block-waves 0-{LARGE_BLOCK_WAVES - 1}: {json.dumps(renders[name])}")
    return {"table_bytes": table_bytes, "compare": compares, "render": renders}


def kernel_rows(batches: dict, renders: dict, large: dict) -> list[dict]:
    rows = []
    for row, (cfg, source, replaces) in KERNEL_ROWS.items():
        if row.endswith("large_table"):
            merged = large["compare"][cfg]
            launches = large["render"][cfg]["kernel_launches"]
            err = merged["max_abs_err_t"]
        else:
            merged = batches[cfg][-1]
            launches = renders[cfg]["kernel_launches"]
            err = max(b["max_abs_err_t"] for b in batches[cfg])
        rows.append({
            "name": row,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": err,
            "ms": merged["kernel_ms"],
            "plain_ms": merged["plain_ms"],
            "bound_ms": merged["bound_ms"],
            "bound_by": merged["bound_by"],
            "library_ms": None,  # no single PyTorch call computes a BVH traversal
        })
    return rows


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
    check(native.sah_available(), f"the native SAH builder did not load: {native.sah_error()}")
    log("phase 2 BVH builder: native binned SAH (shimmer_tpu_torch/native/sah.cpp, g++)")

    # The bench scene: tables built once on the host, copied to the card.
    t0 = time.perf_counter()
    scene_cpu, cam, film = build_bench_scene(BENCH_TRIS, BENCH_RESOLUTION, device="cpu")
    scene_gpu = scene_cpu.to(dev)
    tris = scene_gpu.triangles
    log(f"scene: {tris.orig_indices.shape[0]} triangles, {tris.rows8.shape[0]} BVH8 rows, "
        f"stack depth {tris.stack_depth}, built in {time.perf_counter() - t0:.1f}s")

    # 3. every configuration against the plain version on the card
    batches = phase3(scene_gpu, bench_batches(scene_gpu, cam, film, dev))
    # 4. small render, card against CPU, under every configuration
    phase4(scene_cpu, scene_gpu)
    # 5. the full bench render through the port's entry point (v1)
    renders = {}
    renders["v1"], v1_img = phase5(scene_gpu)
    # 6. the full bench render under the other configurations
    renders.update(phase6(scene_gpu, v1_img))
    del scene_cpu, scene_gpu, tris
    torch.cuda.empty_cache()
    # 7. the 1.3M-triangle leg
    large = phase7(dev)

    print(json.dumps({"kernels": kernel_rows(batches, renders, large)}), flush=True)
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
