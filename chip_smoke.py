"""GPU smoke run of the PyTorch / CUDA port (shimmer_tpu_torch).

Drives the port's forward render path on one CUDA card at the bench
configuration (the scene of bench.py: 327,684 triangles, 1280x720, 16 spp,
depth 5, pixel blocks of 2^17 lanes, 16 samples per wave) under every
traversal configuration, the 1.3M-triangle leg of bench.py, the
row-gather micro-benchmarks (shimmer_tpu_torch.experiments.gather) and the
packet-step micro-benchmarks (shimmer_tpu_torch.experiments.packet_step)
at the reference scripts' sizes, and checks each hand-written kernel
against its plain torch version on the card.

    python3 chip_smoke.py

Phases, each printing its own numbers:
  1. device: a CUDA card is required (no card -> exception, non-zero exit);
  2. build: every kernel library from shimmer_tpu_torch/csrc (traverse.cu,
     gather.cu and packet_step.cu, one nvcc process each, started
     together), with each kernel's registers, stack frame, spills and
     static shared memory, and the native SAH BVH builder (g++), which
     must load: the scenes' tables are built with it;
  3. each traversal configuration (v1, v2, v1 with Moller-Trumbore leaves,
     v1 with the min-id winner, and the combined v1 MT + min-id) against
     the plain version on the card: primary, bounce and merged wavefront
     batches on the full bench scene, each timed on the sorted and the
     unsorted ray layout with its visit statistics, SIMD efficiency,
     resident blocks per SM and bound;
  4. a small render (64x48, 4 spp) on the card and on the CPU under each
     configuration, compared;
  5. the full bench render under v1 through shimmer_tpu_torch.render.render;
  6. the full bench render under v2, v1 with MT leaves and v1 with the
     min-id winner, each compared with the v1 image;
  7. the 1.3M-triangle leg: v1 and v2 against the plain version on one
     merged batch, then pixel-block waves 0-2 rendered under v1 and v2;
  8. the row-gather kernels (gather, transposed gather, gather-sum, float32
     and bf16 row chase) through the entry point's every case, each
     against its plain version on the same tensors (gathers and chases
     bit-equal, the gather-sum within SUM_RTOL), with the library call
     that computes the same function timed beside the kernel where there
     is one (index_select, embedding_bag);
  9. the packet-step kernels (the packet slab chase, the step attribution
     over the bench scene's BVH8 of phase 2, the bf16 hi|lo step
     ablation) through the entry point's every case, each at every step
     count against its plain version on the same tensors, bit for bit,
     with ns per step as the reference scripts report it.
Launch counters are set to 0 just before each render path and each
micro-benchmark entry point, and read just after it.  No phase catches its
own failure.  The last lines are the kernel table as JSON, the card's name
and power limit, and the result object; every log line before them also
goes to chiprun_out/chip_smoke.log.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import time
from pathlib import Path

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
from shimmer_tpu_torch.experiments import gather as eg
from shimmer_tpu_torch.experiments import packet_step as eps
from shimmer_tpu_torch.measure import (
    BLOCK,
    FP32_OPS_PER_S,
    HBM_BYTES_PER_S,
    SPP,
    bench_batches,
    cuda_ms,
    launch_bound,
    launch_kwargs,
    layouts,
    ptxas_report,
)
from shimmer_tpu_torch.ops import cuda_build
from shimmer_tpu_torch.ops import gather as gk
from shimmer_tpu_torch.ops import packet_step as pk
from shimmer_tpu_torch.ops import traverse as tv
from shimmer_tpu_torch.ops.traverse import TraverseConfig
from shimmer_tpu_torch.render import make_wavefront_renderer, pixel_blocks, render
from shimmer_tpu_torch.samplers import ZSobolSampler
from shimmer_tpu_torch.shapes.triangle import (
    _A_P0,
    intersect_triangle,
    intersect_triangle_mt,
    triangle_interaction_from_raw,
)

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
# The bound of a traversal launch is measure.traversal_bound: the rows,
# meta words and visits of that launch itself, so the v1 kernel's
# near-first order, which visits less, lowers its own bound.  The bound
# from the visits of the kernel before its redesign, on the same rays,
# comes from experiments/kernel_ab.py run on that checkout (PERF.md).
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
# The row-gather kernels of kernel-table rows 6-9 -> (the entry point's
# case whose times the kernel table carries, the TPU functions it ports).
# Their bound uses the rates above and the work the entry point counts on
# each case's inputs: bytes count each input once (the distinct rows read,
# by the columns the function needs) and each output once; operations are
# float32 additions (the chase's 8 a step plus its index conversion).
GATHER_SOURCE = "shimmer_tpu_torch/csrc/gather.cu"
GATHER_ROWS = {
    "row_gather": (
        "8/9 row_gather R=16384 N=131072 W=128 K=1",
        "experiments/pallas_gather2.py:43 (check_and_bench_taa0, its gather); "
        "experiments/exp_pallas_gather.py:51 (make_take); experiments/exp_pallas_gather.py:84 "
        "(make_scalar); experiments/exp_pallas_gather2.py:36 (make_scalar); "
        "experiments/exp_pallas_gather2.py:101 (make_taa)"),
    "row_gather_cols": (
        "7G row_gather_cols R=8192 N=8192 W=128 K=1",
        "experiments/pallas_gather2.py:116 (check_and_bench_taa1)"),
    "row_gather_sum": (
        "9 row_gather_sum R=16384 N=131072 W=128 K=1",
        "experiments/exp_pallas_gather2.py:74 (make_scalar_reduce); "
        "experiments/pallas_gather.py:181 (bench_pallas_dma)"),
    "row_chase_f32": (
        "6A/6B/6B2 row_chase_f32 R=16384 N=131072 W=128 K=32",
        "experiments/pallas_gather.py:72 (bench_pallas_vmem_take); experiments/pallas_gather.py:106 "
        "(bench_pallas_vmem_take_cols); experiments/pallas_gather.py:232 "
        "(bench_pallas_scalar_rows); experiments/pallas_gather2.py:73 (check_and_bench_taa0, "
        "its chase)"),
    "row_chase_bf16": (
        "6C row_chase_bf16 R=16384 N=131072 W=128 K=8",
        "experiments/pallas_gather.py:140 (bench_pallas_onehot)"),
}


# The packet-step kernels of kernel-table rows 10-16 -> (kernel, the entry
# point's case whose times the row carries, the TPU function it ports).
# Launches and max_abs_err cover every case of the row; the bound is the
# entry point's (experiments/packet_step.py: bytes of the rows, nxt and
# meta words this run's chain reads, by the columns a step uses, plus the
# rays and the output; float operations of the steps this run's data
# takes), at the case's largest step count.
PACKET_SOURCE = "shimmer_tpu_torch/csrc/packet_step.cu"
PACKET_ROWS = {
    "10": ("packet_slab_chase", "10 make packet_slab_chase/slab transposed",
           "experiments/exp_scaling.py:38 (make; pallas_call :47)"),
    "11": ("packet_slab_chase", "11 step_kernel packet_slab_chase/slab_stack transposed",
           "experiments/exp_packet_step.py:40 (step_kernel; pallas_call :87)"),
    "12": ("packet_slab_chase", "12 A roll packet_slab_chase/slab transposed",
           "experiments/exp_packet_step2.py:65 (make, fetch A-D; pallas_call :66)"),
    "13": ("packet_slab_chase", "13 A roll packet_slab_chase/slab transposed",
           "experiments/exp_fetch_honest.py:82 (make, empty and A-D; pallas_call :92)"),
    "14": ("packet_slab_chase", "14 k6 fetch+slab while packet_slab_chase/slab transposed",
           "experiments/exp_loop_overhead.py:57 (make, k1-k6; pallas_call :58)"),
    "15": ("step_attrib", "15 full step_attrib/full",
           "experiments/exp_step_attrib.py:43 (kern; pallas_call :208)"),
    "16": ("step_ablate", "16 v4 step_ablate/v4",
           "experiments/exp_ablate_step.py:32 (kern; run :127, pallas_call :128)"),
}


# Every log line also goes to this file (opened once the card is found),
# since a run prints more than the tail of its output that a caller keeps.
LOG_PATH = Path("chiprun_out") / "chip_smoke.log"
_log_file = None


def log(msg):
    print(msg, flush=True)
    if _log_file is not None:
        _log_file.write(msg + "\n")
        _log_file.flush()


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


def compare_traversal(tris, o, d, t_max, any_hit, name: str, plain=None) -> dict:
    """The kernel of ``tris.traverse`` (traverse_raw on CUDA tensors)
    against traverse_raw_plain on the same tensors: equal hit masks (so
    equal occlusion bits on any-hit lanes), bit-equal t where both hit,
    equal tri except at exact t ties.  Counts the closest-hit lanes whose
    watertight re-intersection misses the kernel's winner (0 for
    watertight leaves) and checks that the interaction turns each into a
    miss.  Then times the kernel on the sorted and the unsorted layout,
    with its visit statistics, bound and occupancy (resident blocks per SM,
    and the blocks of the launch resident at once on the card)."""
    cfg = tris.traverse
    n = o.shape[0]
    want = torch.broadcast_to(torch.as_tensor(any_hit, device=o.device), (n,)).contiguous()
    t_k, tri_k = tv.traverse_raw(tris, o, d, t_max, any_hit=want)
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

    lay = layouts(tris, o, d, t_max, want)
    srt = lay["sorted"]
    kw = launch_kwargs(tris)
    kernel_bound, stats = launch_bound(tris, srt, cfg)
    blocks_per_sm = tv.blocks_per_sm(cfg)
    sms = torch.cuda.get_device_properties(o.device).multi_processor_count
    res = {
        "kernel": cfg.name,
        "batch": name,
        "rays": n,
        "live": int((t_max > 0).sum()),
        "hits": int(hit_k.sum()),
        "tri_ties": int(tri_diff.sum()),
        "anyhit_mismatch": int((hit_k != hit_p)[want].sum()),
        "rehit_miss": int(rehit_miss.sum()),
        "max_abs_err_t": max_err,
        "kernel_ms": cuda_ms(lambda: tv._launch_kernel(*srt, False, cfg, **kw), reps=10),
        "kernel_ms_unsorted": cuda_ms(
            lambda: tv._launch_kernel(*lay["unsorted"], False, cfg, **kw), reps=10),
        "wrapper_ms": cuda_ms(lambda: tv.traverse_raw(tris, o, d, t_max, any_hit=want), reps=10),
        "plain_ms": cuda_ms(
            lambda: tv.traverse_raw_plain(tris.rows8, tris.stack_depth, o, d, t_max, want,
                                          leaf=cfg.leaf, winner=cfg.winner), reps=2),
        **stats,
        **kernel_bound,
        "blocks_per_sm": blocks_per_sm,
        "resident_blocks": blocks_per_sm * sms,
    }
    log(f"phase 3 {cfg.name} {name}: {json.dumps(res)}")
    return res


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


def library_call(kernel: str, table, idx):
    """The one PyTorch call that computes a gather kernel's function on
    the same inputs (timed as a yardstick only; no single PyTorch call
    computes a dependent chase)."""
    if kernel == "row_gather":
        return lambda: torch.index_select(table, 0, idx)
    if kernel == "row_gather_cols":
        return lambda: torch.index_select(table, 1, idx)
    return lambda: torch.nn.functional.embedding_bag(idx[None], table, mode="sum")


def gather_bound(res: dict) -> dict:
    """The bound of one row-gather case from the work the entry point
    counted on its inputs (GATHER_ROWS): bound_ms and bound_by."""
    t_bytes = res["bytes"] / HBM_BYTES_PER_S
    t_ops = res["ops"] / FP32_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase8(dev) -> dict:
    """The row-gather entry point, every case at the reference sizes, its
    launches counted from 0; then the library yardsticks and the bounds."""
    torch.cuda.synchronize()
    gk.reset_launches()
    t0 = time.perf_counter()
    rows = eg.main(device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = gk.launch_counts()
    for name, res in rows.items():
        check(res["ok"], f"phase 8 {name}: the kernel disagrees with its plain version "
                         f"(max |d| {res['max_abs_err']})")
    for kernel in eg.KERNELS:
        check(launches[kernel] > 0, f"phase 8: the {kernel} kernel was not launched")
    oob = {name: res["oob_lanes"] for name, res in rows.items() if res["kernel"] == "row_chase_bf16"}
    check(sum(oob.values()) > 0, "phase 8: no bf16 chase lane met an index rounded out of range")
    log(f"phase 8 entry point: {len(rows)} cases in {seconds:.1f}s, launches {json.dumps(launches)}, "
        f"bf16 chase lanes that met an out-of-range index {json.dumps(oob)}")
    # The library yardsticks, on each case's own inputs (made again from
    # the entry point's SEED), after the counted run.
    library = {}
    for case in eg.cases():
        if case.kernel.startswith("row_chase"):
            continue
        table, idx = eg.make_inputs(case, dev)
        lib = library_call(case.kernel, table, idx)
        if case.kernel != "row_gather_sum":
            kernel = gk.row_gather_cols if case.kernel == "row_gather_cols" else gk.row_gather
            check(torch.equal(lib(), kernel(table, idx)),
                  f"phase 8 {case.name}: index_select disagrees with the kernel")
        library[case.name] = eg.time_ms(lib, dev)
    for name, res in rows.items():
        keys = ("ms", "plain_ms", "max_abs_err", "max_rel_err", "distinct_rows", "ns_per_step",
                "oob_lanes", "checksum")
        line = {**{k: res[k] for k in keys if k in res}, **gather_bound(res),
                "library_ms": library.get(name)}
        log(f"phase 8 case {name}: {json.dumps(line)}")

    out = {}
    for kernel, (case_name, _) in GATHER_ROWS.items():
        res = rows[case_name]
        out[kernel] = {
            "case": case_name,
            "launches": launches[kernel],
            "max_abs_err": max(r["max_abs_err"] for r in rows.values() if r["kernel"] == kernel),
            "ms": res["ms"],
            "plain_ms": res["plain_ms"],
            "library_ms": library.get(case_name),
            **gather_bound(res),
            "distinct_rows": res["distinct_rows"],
            "bytes": res["bytes"],
            "ops": res["ops"],
        }
        if "ns_per_step" in res:
            out[kernel]["ns_per_step"] = res["ns_per_step"]
        if "max_rel_err" in res:
            out[kernel]["max_rel_err"] = max(r["max_rel_err"] for r in rows.values()
                                             if r["kernel"] == kernel)
            out[kernel]["rel_tolerance"] = eg.SUM_RTOL
        log(f"phase 8 {kernel}: {json.dumps(out[kernel])}")
    return out


def phase9(dev, tables) -> dict:
    """The packet-step entry point, every case at the reference sizes
    (row 15 on the bench scene's ``tables``), its launches counted from 0;
    returns the kernel-table rows 10-16."""
    torch.cuda.synchronize()
    pk.reset_launches()
    t0 = time.perf_counter()
    rows = eps.main(device=dev, tables=tables)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = pk.launch_counts()
    for name, res in rows.items():
        check(res["ok"], f"phase 9 {name}: the kernel disagrees with its plain version "
                         f"(max |d| {res['max_abs_err']})")
    for kernel in pk.KERNELS:
        # The cases count their timed launches, not the ones compared
        # with the plain version.
        timed = sum(r["launches"] for r in rows.values() if r["kernel"] == kernel)
        check(timed > 0, f"phase 9: the {kernel} kernel was not launched")
        check(launches[kernel] > timed, f"phase 9: {kernel} launched {launches[kernel]} times, "
                                        f"its cases timed {timed}")
    smi = nvidia_smi_line()
    log(f"phase 9 entry point: {len(rows)} cases in {seconds:.1f}s, launches {json.dumps(launches)}")
    for name, res in rows.items():
        keys = ("ns_per_step", "ns_per_step_per_program", "marginal_ns", "ms", "chain_ms",
                "plain_ms", "bound_ms", "bound_by", "bytes", "ops", "launches", "max_abs_err")
        line = {k: res[k] for k in keys if k in res}
        line["steps"] = {s: {k: p[k] for k in ("ms", "chain_ms", "plain_ms", "checksum") if k in p}
                         for s, p in res["steps"].items()}
        log(f"phase 9 case {name} [{smi}]: {json.dumps(line)}")
    out = {}
    for row, (kernel, case_name, replaces) in PACKET_ROWS.items():
        res = rows[case_name]
        of_row = [r for r in rows.values() if r["row"] == row]
        out[row] = {
            "name": f"{kernel}:row{row}",
            "route": "cuda",
            "source": PACKET_SOURCE,
            "replaces": replaces,
            "launches": sum(r["launches"] for r in of_row),
            "max_abs_err": max(r["max_abs_err"] for r in of_row),
            **{k: res[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "library_ms": None,  # no single PyTorch call computes a packet step
        }
        log(f"phase 9 row {row} ({case_name}): {json.dumps(out[row])}")
    return out


def kernel_rows(batches: dict, renders: dict, large: dict, gathers: dict,
                packets: dict) -> list[dict]:
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
    for kernel, (_, replaces) in GATHER_ROWS.items():
        res = gathers[kernel]
        rows.append({
            "name": kernel,
            "route": "cuda",
            "source": GATHER_SOURCE,
            "replaces": replaces,
            **{k: res[k] for k in ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms")},
        })
    rows.extend(packets.values())
    return rows


def main():
    # 1. device
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card; none is available")
    dev = torch.device("cuda", 0)
    global _log_file
    LOG_PATH.parent.mkdir(exist_ok=True)
    _log_file = open(LOG_PATH, "w")
    smi = nvidia_smi_line()
    log(f"phase 1 device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; {smi}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    build = cuda_build.build(force=True)
    log(f"phase 2 build: {time.perf_counter() - t0:.2f}s for {len(build)} libraries")
    for name, b in build.items():
        check(b["built"], f"phase 2: the {name} library was not built")
        log(f"phase 2 build {name}: {b['seconds']:.2f}s")
        for kernel in ptxas_report(b["log"]):
            log(f"phase 2 build {name} kernel: {json.dumps(kernel)}")
    check(native.sah_available(), f"the native SAH builder did not load: {native.sah_error()}")
    log("phase 2 BVH builder: native binned SAH (shimmer_tpu_torch/native/sah.cpp, g++)")

    # The bench scene: tables built once on the host, copied to the card.
    t0 = time.perf_counter()
    scene_cpu, cam, film = build_bench_scene(BENCH_TRIS, BENCH_RESOLUTION, device="cpu")
    scene_gpu = scene_cpu.to(dev)
    tris = scene_gpu.triangles
    log(f"scene: {tris.orig_indices.shape[0]} triangles, {tris.rows8.shape[0]} BVH8 rows, "
        f"stack depth {tris.stack_depth}, built in {time.perf_counter() - t0:.1f}s")
    # Row 15 of phase 9 steps over these tables.
    bench_tables = (tris.rows8, tris.meta, tris.stack_depth)

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
    torch.cuda.empty_cache()
    # 8. the row-gather kernels through their micro-benchmark entry point
    gathers = phase8(dev)
    # 9. the packet-step kernels through theirs
    packets = phase9(dev, bench_tables)

    print(json.dumps({"kernels": kernel_rows(batches, renders, large, gathers, packets)}),
          flush=True)
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
