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
     configuration, compared (this phase's and phases 10-18's CPU halves
     run in two processes of their own, started after the build, beside
     the card's phases);
  5. the full bench render under v1 through shimmer_tpu_torch.render.render;
  6. the full bench render under v2, v1 with MT leaves and v1 with the
     min-id winner, each compared with the v1 image;
  7. the 1.3M-triangle leg: v1 and v2 against the plain version on one
     merged batch, then pixel-block waves 0-2 rendered under v1 and v2;
  8. the row-gather kernels (gather, transposed gather, gather-sum direct
     and counted, one-column sum, float32 and bf16 row chase, 6E's
     one-lane chase staged and its walk alone, chain_ms) through the entry
     point's every case, each against its plain version on the same
     tensors (gathers and chases bit-equal, the gather-sums within
     SUM_RTOL), each chase and gather-sum in the form its rule names; each
     gather-sum launched twice, the same bits both times, and equal to the
     host build of its body (csrc/gather_host.cpp, g++) on the same inputs
     copied to the CPU; the one-column sum's floor (N = 32, floor_ms); with
     the library call that computes the same function timed beside the
     kernel where there is one (index_select, embedding_bag);
  9. the packet-step kernels (the packet slab chase, the step attribution
     over the bench scene's BVH8 of phase 2 and its chain alone, the bf16
     hi|lo step ablation) through the entry point's every case, each at
     every step count against its plain version on the same tensors, bit
     for bit, with ns per step as the reference scripts report it, the
     chain alone's time (chain_ms) where a case has one, and the shape of
     row 16's chains (mu, lambda, distinct rows);
 10. the material bench scene (bench_scene.build_material_bench_scene: the
     bench geometry with a mix of rough gold and dispersive BK7 glass on the
     sphere and a coated diffuse floor): a small render (64x48, 4 spp) on
     the card and on the CPU, compared, then the full render under v1
     through shimmer_tpu_torch.render.render at 1280x720 and MATERIAL_SPP
     (4) samples per pixel;
 11. scene files through the port's pbrt-v4 loader: (a) the three
     committed golden scenes (tests/scenes/*.pbrt, analytic spheres beside
     triangles) rendered on the card under v1 at their in-file settings
     and held against tests/scenes/golden_*.npz at tests/test_golden.py's
     tolerances; (b) a loaded scene at full width: the bench sphere
     written as a binary PLY, with the bench camera, floor, emissive quad
     and infinite light and three analytic spheres (dielectric, rough
     gold, and a small sphere area light) in a .pbrt file, rendered at
     1280x720, LOADED_SPP (4) spp, depth 5 through
     shimmer_tpu_torch.cli.main to a PFM that must equal the image render
     returned, then the same file at 64x48, 4 spp on the card and on the
     CPU, compared;
 12. textures and the image environment light: phase 11's scene with a
     2048^2 checker image on the floor (trilinear), a coated diffuse mesh
     with a cylindrical-mapped texture and a bump map, a gold sphere with
     a 1024^2 EWA roughness map through a scale texture, a mix sphere
     with a textured amount over a direction-mix diffuse, and a 2048x1024
     lat-long PFM environment light, written in code and rendered at
     1280x720, LOADED_SPP (4) spp, depth 5 through
     shimmer_tpu_torch.cli.main with the load split into image reads,
     pyramids and fits, the env bake, the PLY read, the BVH build and the
     rest; then the same file at 64x48, 4 spp on the card twice (film
     states torch.equal) and on the CPU, compared;
 13. delta lights and homogeneous media: phase 11's scene in an exterior
     fog (the camera's medium, MediumInterface "" "fog" before Camera;
     its camera-to-floor transmittance 0.3-0.7, checked), a 12-triangle
     box of interface material turned 45 degrees about y holding a denser
     smoke (g 0.6) around the bench sphere, and a point, a spot (3000 K
     blackbody, cone 25 with 5 of falloff) and a distant light, written in
     code and rendered at 1280x720, LOADED_SPP (4) spp, depth 5 through
     shimmer_tpu_torch.cli.main to a PFM that must equal the returned
     image, with v1 launches exactly 4 an iteration (the merged trace and
     three shadow-march rounds) and the media's RGB fits timed apart;
     then at 64x48, 4 spp on the card and on the CPU, compared, for that
     scene, for the fog without the box (one launch an iteration) and
     for the delta lights without media (one launch an iteration);
 14. bilinear patches and two-level instancing: phase 11's camera,
     infinite light and bench sphere (world triangles, so v1 keeps its
     bench-size table), 24 instances (scales 0.15-0.35, turned about y)
     of an object holding the same PLY and a small glass sphere (7,864,320
     instanced triangles over one object BVH, 24 copied spheres), a planar
     patch floor, a 4x4 twisted patch wall with uvs under a conductor and
     a patch quad light beside the triangle quad light, under the power
     light sampler, written in code and rendered at 1280x720, INSTANCED_SPP
     (4) spp, depth 5 through shimmer_tpu_torch.cli.main to a PFM that
     must equal the returned image, with v1 launches exactly one an
     iteration, the instanced loop's steps and CUDA-event ms a trace, the
     patch leg's ms a trace, the load split (PLY reads, object BVH, top
     build, world BVH, patch table, the rest) and the instanced table's
     bytes beside 24 flattened copies'; then at 64x48, 4 spp on the card
     and on the CPU, compared, and tests/test_parser.py's instanced and
     bilinear scenes (zsobol for their independent sampler) likewise;
 15. the masked megakernel and the other estimators: (a) the bench scene
     of phase 5 through render(..., wavefront=False) under v1 at
     MEGAKERNEL_SPP (4) spp, with exactly n_blocks x spp x (1 + depth) v1
     launches, against a wavefront render at that spp (the same estimator
     and draws), with its seconds, rays, lane occupancy (rays / (launches
     x 2 x BLOCK)), ms a bounce and peak memory; (b) at 64x48, 4 spp, the
     card against the CPU through the loader: phase 11's file under the
     megakernel, "simplepath" and "randomwalk", phase 13's interface
     scene under the megakernel (each with its exact launch count), and
     four small feature scenes holding the independent and stratified
     samplers, the gaussian, mitchell, sinc and triangle filters, the
     orthographic and spherical (both mappings) cameras, a thin lens with
     a screen window, the camera and world render spaces, both jitter
     options, ColorSpace rec2020 and the film's ISO and white balance;
 16. checkpoints, splats and gradients: (b) RgbFilm.add_splats of 2^20
     samples (~114 a pixel, Gaussian footprints) twice on the card, the
     same bits, and within rtol 1e-4 of the CPU; (a) a checkpointed render
     of the bench scene at 320x180, 4 spp, one sample a wave, in a process
     of its own that is killed after its second wave, resumed in another
     new process, its final film state torch.equal to this process's
     uninterrupted render; (c) tests/test_grad.py::TestGradients' four
     scenes (the texture case twice) at its sizes: the card's AD against
     its own central finite difference at that file's tolerances and
     within 1e-3 of the CPU's AD; (d) the bench scene at 1280x720, 1 spp,
     depth 5 through render(wavefront=False) with li_path(remat="full")
     over all 8 pixel blocks, the gradient of the image mean with respect
     to the floor's reflectance coefficients finite and nonzero, exactly
     n_blocks x (1 + 2 x depth) v1 launches (each bounce's trace runs
     again in its recompute), with forward and backward seconds and peak
     device memory;
 17. the replay wavefront (render.make_replay_wavefront_renderer): (a)
     tests/test_grad.py::TestReplayWavefrontGradients' scene at its sizes,
     the replay value against the wavefront's, its gradient against the
     megakernel's, both against the CPU's; (b) phase 16 (d)'s bench
     backward through the replay over all 8 pixel blocks, its gradient
     against phase 16 (d)'s, v1 launches exactly the wavefront's
     iterations plus n_blocks x (1 + depth) for the replay, with forward
     and backward seconds and peak device memory;
 18. sharding (shimmer_tpu_torch.parallel): the bench at 1280x720,
     SHARD_SPP (4) spp, depth 5 over two row bands of the card in tiles
     mode (a) and in spp mode over two waves (b), each against phase
     15's unsharded wavefront image of the same samples, v1 launches
     exactly the bands' iterations; (c) a process of its own joins a
     world of one over NCCL (one card: NCCL puts no two ranks on one
     card) and renders the flagship through render_multihost, its image
     against this process's, and runs the sharded training step; (d)
     flagship.dryrun_multichip on two bands of the card against the CPU.
Launch counters are set to 0 just before each render path and each
micro-benchmark entry point, and read just after it.  No phase catches its
own failure.  Each phase logs its wall seconds and the run's so far.  The
last lines are the kernel table as JSON, the card's name and power limit,
and the result object; every log line before them also goes to
chiprun_out/chip_smoke.log.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import multiprocessing
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from shimmer_tpu_torch import cli, native
from shimmer_tpu_torch import render as render_module
from shimmer_tpu_torch.bench_scene import (
    BENCH_RESOLUTION,
    BENCH_TRIS,
    LARGE_TRIS,
    bench_camera_film,
    build_bench_scene,
    build_material_bench_scene,
    make_displaced_sphere,
)
from shimmer_tpu_torch.cameras import CameraTransform, PerspectiveCamera
from shimmer_tpu_torch.color.colorspace import get_named_color_space
from shimmer_tpu_torch.film.film import PixelSensor, RgbFilm
from shimmer_tpu_torch.film.filters import BoxFilter, GaussianFilter, get_camera_sample
from shimmer_tpu_torch.film.image import Image
from shimmer_tpu_torch.flagship import dryrun_multichip, flagship
from shimmer_tpu_torch.integrators.path import li_path
from shimmer_tpu_torch.lights import lights as lt
from shimmer_tpu_torch.loading.parser import parse_file
from shimmer_tpu_torch.loading.scene_builder import SceneBuilder
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
    patterned_stack,
    ptxas_report,
)
from shimmer_tpu_torch.materials import material as mtl
from shimmer_tpu_torch.ops import cuda_build
from shimmer_tpu_torch.ops import gather as gk
from shimmer_tpu_torch.ops import packet_step as pk
from shimmer_tpu_torch.ops import traverse as tv
from shimmer_tpu_torch.ops.transform import Transform
from shimmer_tpu_torch.ops.traverse import TraverseConfig
from shimmer_tpu_torch.parallel.distributed import initialize_distributed, render_multihost
from shimmer_tpu_torch.parallel.render import make_tile_mesh, render_sharded
from shimmer_tpu_torch.render import make_wavefront_renderer, pixel_blocks, render
from shimmer_tpu_torch.samplers import IndependentSampler, ZSobolSampler
from shimmer_tpu_torch.scene_builder import build_scene
from shimmer_tpu_torch.shapes.triangle import (
    _A_P0,
    intersect_triangle,
    intersect_triangle_mt,
    triangle_interaction_from_raw,
)
from shimmer_tpu_torch.spectra.sampled import SampledWavelengths
from shimmer_tpu_torch.spectra.spectrum import ConstantSpectrum
from shimmer_tpu_torch.textures import textures as tx

WAVE_SPP = 16
MAX_DEPTH = 5
SMALL_RES = (64, 48)
SMALL_SPP = 4
LARGE_BLOCK_WAVES = 3
# Phase 10's full render runs at 4 spp, not the bench's 16: the layered
# walks' host dispatch made it ~220 s, and phase 12 needs the time.
MATERIAL_SPP = 4
# Phases 11-13's full renders through the CLI run at 4 spp, not the
# bench's 16 (33.4, 222.8 and 100.8 s at 16 on an H100 80GB HBM3 at 700
# W): at 16 the whole run passed its 1,200 s limit.
LOADED_SPP = 4
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
        "9 row_gather_sum R=16384 N=8192 W=128 K=1",
        "experiments/exp_pallas_gather2.py:74 (make_scalar_reduce): the direct form, where N "
        "is small against R"),
    "row_gather_sum_counted": (
        "9 row_gather_sum R=16384 N=131072 W=128 K=1",
        "experiments/exp_pallas_gather2.py:74 (make_scalar_reduce): the counted form, each "
        "distinct row read once and added times its count"),
    "row_gather_col_sum": (
        "6D row_gather_col_sum R=16384 N=8192 W=128 K=4",
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
    "row_chase_staged": (
        "6A/6B/6B2 row_chase_f32 R=16384 N=131072 W=128 K=32",
        "experiments/pallas_gather.py:72 (bench_pallas_vmem_take); experiments/pallas_gather.py:106 "
        "(bench_pallas_vmem_take_cols); experiments/pallas_gather.py:140 (bench_pallas_onehot); "
        "experiments/pallas_gather.py:232 (bench_pallas_scalar_rows); "
        "experiments/pallas_gather2.py:73 (check_and_bench_taa0, its chase): the staged form, "
        "each row's next index and row sum written by a pass and walked from shared memory"),
    "chase_walk": (
        "6E row_chase_f32 R=16384 N=1 W=128 K=4096",
        "experiments/pallas_gather.py:232 (bench_pallas_scalar_rows: the staged walk alone, "
        "over each row's next index and row sum)"),
}
# The case whose staged walk the chase_walk line carries (6E: one lane,
# 4,096 steps; the row_chase_f32 line carries the wide chase).
WALK_CASE = GATHER_ROWS["chase_walk"][0]
# The chases the card runs staged (ops.gather.chase_staged, set by timing
# every chase case in each form, PERF.md): all but 6C's at N = 8,192.
def staged_by_measurement(res: dict) -> bool:
    return res["kernel"].startswith("row_chase") and not (res["row"] == "6C"
                                                          and res["N"] == 8192)


# The gather-sums the card runs counted (ops.gather.gather_sum_counted,
# set by timing both forms over a grid of sizes, PERF.md): row 9 at N =
# 131,072; its sums at 6D's sizes (N = 8,192) run direct.
def counted_by_measurement(res: dict) -> bool:
    return res["kernel"] == "row_gather_sum" and res["N"] == 131072


# The per-lane chase beyond the staged form's table limit, held against
# its plain version after the entry point: R, N, K.
PER_LANE_CASE = (gk.STAGE_MAX_ROWS + 1, 4096, 32)


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


class PhaseWall:
    """Logs each phase's wall seconds and the run's so far."""

    def __init__(self):
        self.start = self.last = time.perf_counter()

    def mark(self, phase: int):
        now = time.perf_counter()
        log(f"phase {phase} wall: {now - self.last:.1f}s (run {now - self.start:.1f}s)")
        self.last = now


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


def small_bench_render(scene, name: str) -> np.ndarray:
    """The bench scene (or phase 10's) at SMALL_RES and SMALL_SPP under
    configuration ``name``, on the scene's device."""
    cam, film = bench_camera_film(SMALL_RES)
    img, _ = render(with_config(scene, name), cam, film, ZSobolSampler(SMALL_SPP, SMALL_RES),
                    spp=SMALL_SPP, max_depth=MAX_DEPTH, wave_spp=SMALL_SPP, pixel_block=BLOCK)
    return img.cpu().numpy()


def phase4_cpu_config(name: str) -> str:
    """The configuration whose CPU image phase 4 holds ``name``'s card
    image to: the CPU runs the plain version, which v1 and v2 share."""
    cfg = CONFIGS[name]
    return next(n for n, c in CONFIGS.items() if (c.leaf, c.winner) == (cfg.leaf, cfg.winner))


def phase4(scene_gpu) -> dict:
    out = {}
    for name in CONFIGS:
        images, seconds = {}, {}
        t0 = time.perf_counter()
        images["gpu"] = small_bench_render(scene_gpu, name)
        seconds["gpu"] = time.perf_counter() - t0
        images["cpu"], seconds["cpu"] = cpu_image(f"p4_{phase4_cpu_config(name)}")
        for dev_name, img in images.items():
            check(np.isfinite(img).all() and img.mean() > 0, f"phase 4 {name}: bad {dev_name} image")
        agree = check_agreement(f"phase 4 {name}", images["gpu"], images["cpu"])
        log(f"phase 4 {name} small render {SMALL_RES[0]}x{SMALL_RES[1]} spp {SMALL_SPP}: "
            f"seconds {json.dumps(seconds)} {json.dumps(agree)}")
        out[name] = agree
    return out


def full_render(scene_gpu, name: str, phase: str, spp: int = SPP) -> tuple[dict, np.ndarray]:
    """The full bench render under configuration ``name`` at ``spp``; its
    launches are counted from 0."""
    cam, film = bench_camera_film(BENCH_RESOLUTION)
    sampler = ZSobolSampler(spp, BENCH_RESOLUTION)
    n_blocks = -(-BENCH_RESOLUTION[0] * BENCH_RESOLUTION[1] // BLOCK)
    scene = with_config(scene_gpu, name)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    img, _, stats = render(scene, cam, film, sampler, spp=spp, max_depth=MAX_DEPTH,
                           wave_spp=WAVE_SPP, pixel_block=BLOCK, collect_stats=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts(f"{phase} {name}", name)
    img = img.cpu().numpy()
    check(np.isfinite(img).all(), f"{phase} {name}: non-finite image")
    check(img.mean() > 0, f"{phase} {name}: black image")
    waves = -(-spp // WAVE_SPP)
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
    # The gather-sums: all W columns (6D's one-column sum computes less).
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
    # Each chase ran in the form the rule names (ops.gather.chase_staged,
    # held to the library's bounds), and the rule names the measured set.
    for name, res in rows.items():
        if "staged" in res:
            check(res["ran_staged"] == res["staged"],
                  f"phase 8 {name}: ran {'staged' if res['ran_staged'] else 'per lane'}, "
                  f"the rule says {'staged' if res['staged'] else 'per lane'}")
    staged = sorted(name for name, res in rows.items() if res.get("staged"))
    check(staged == sorted(name for name, res in rows.items() if staged_by_measurement(res)),
          f"phase 8: the staged chase ran for {staged}")
    # Likewise each gather-sum (ops.gather.gather_sum_counted); and every
    # gather-sum gave the same bits on its two launches.
    for name, res in rows.items():
        if "counted" in res:
            check(res["ran_counted"] == res["counted"],
                  f"phase 8 {name}: ran {'counted' if res['ran_counted'] else 'direct'}, "
                  f"the rule says {'counted' if res['counted'] else 'direct'}")
        if "repeat_equal" in res:
            check(res["repeat_equal"], f"phase 8 {name}: two launches gave different bits")
    counted = sorted(name for name, res in rows.items() if res.get("counted"))
    check(counted == sorted(name for name, res in rows.items() if counted_by_measurement(res)),
          f"phase 8: the counted gather-sum ran for {counted}")
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
        if case.kernel in ("row_gather", "row_gather_cols"):
            kernel = gk.row_gather_cols if case.kernel == "row_gather_cols" else gk.row_gather
            check(torch.equal(lib(), kernel(table, idx)),
                  f"phase 8 {case.name}: index_select disagrees with the kernel")
        library[case.name] = eg.time_ms(lib, dev)
    for name, res in rows.items():
        keys = ("ms", "chain_ms", "chain_plain_ms", "floor_ms", "plain_ms", "max_abs_err",
                "max_rel_err", "distinct_rows", "ns_per_step", "oob_lanes", "checksum", "counted",
                "repeat_equal")
        line = {**{k: res[k] for k in keys if k in res}, **gather_bound(res),
                "library_ms": library.get(name)}
        log(f"phase 8 case {name}: {json.dumps(line)}")

    out = {}
    for kernel, (case_name, _) in GATHER_ROWS.items():
        if kernel == "chase_walk":
            continue  # below
        res = rows[case_name]
        out[kernel] = {
            "case": case_name,
            "launches": launches[kernel],
            "max_abs_err": max(r["max_abs_err"] for r in rows.values() if kernel in r["kernels"]),
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
                                             if kernel in r["kernels"])
            out[kernel]["rel_tolerance"] = eg.SUM_RTOL
        if "floor_ms" in res:
            out[kernel]["floor_ms"] = res["floor_ms"]
            out[kernel]["library_computes"] = "embedding_bag: all 128 columns, more than 6D's one"
        log(f"phase 8 {kernel}: {json.dumps(out[kernel])}")
    # 6E's staged walk alone, a kernel of its own.
    res = rows[WALK_CASE]
    t_bytes = res["chain_bytes"] / HBM_BYTES_PER_S
    t_ops = res["chain_ops"] / FP32_OPS_PER_S
    out["chase_walk"] = {
        "case": WALK_CASE,
        "launches": launches["chase_walk"],
        "max_abs_err": res["max_abs_err"],  # held bit-equal to the chase (ok)
        "ms": res["chain_ms"],
        "plain_ms": res["chain_plain_ms"],
        "library_ms": None,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": res["chain_bytes"],
        "ops": res["chain_ops"],
    }
    log(f"phase 8 chase_walk: {json.dumps(out['chase_walk'])}")
    per_lane_beyond_stage(dev)
    gather_sums_against_host(dev)
    return out


def gather_sums_against_host(dev):
    """Each gather-sum case of the entry point (and the one-column sum at
    its floor's N), its inputs made again from the entry point's SEED: the
    card's sum, launched twice, and the host build of the kernels' bodies
    (csrc/gather_host.cpp, g++ without FMA contraction) on the same inputs
    copied to the CPU, all the same bits."""
    host = cuda_build.load_host("gather")
    p, ci = ctypes.c_void_p, ctypes.c_int
    host.shimmer_row_gather_sum_host.argtypes = [p, ci, ci, p, ci, p]
    host.shimmer_row_gather_col_sum_host.argtypes = [p, ci, ci, p, ci, ci, ci, p]
    checks = []
    for case in eg.cases():
        table, idx = eg.make_inputs(case, dev)
        if case.kernel == "row_gather_sum":
            checks.append((case.name, table, idx, ()))
        elif case.kernel == "row_gather_col_sum":
            for ix in (idx, idx[:eg.FLOOR_N]):
                checks.append((f"{case.name} at N={ix.shape[0]}", table, ix,
                               (eg.COL_SUM_COL, case.steps)))
    for name, table, idx, col in checks:
        def card():
            return (gk.row_gather_col_sum(table, idx, *col) if col
                    else gk.row_gather_sum(table, idx)).cpu().view(torch.int32)

        first, second = card(), card()
        tc, ic = table.cpu(), idx.cpu()
        want = torch.empty(() if col else tc.shape[1])
        fn = host.shimmer_row_gather_col_sum_host if col else host.shimmer_row_gather_sum_host
        check(fn(tc.data_ptr(), tc.shape[0], tc.shape[1], ic.data_ptr(), ic.shape[0], *col,
                 want.data_ptr()) == 0, f"phase 8 {name}: the host build refused the case")
        check(torch.equal(first, second), f"phase 8 {name}: two launches gave different bits")
        check(torch.equal(first, want.view(torch.int32)),
              f"phase 8 {name}: the card's sum differs from the host build's")
        log(f"phase 8 {name}: two launches and the host build the same bits")


def per_lane_beyond_stage(dev):
    """The per-lane chase, float32 and bf16, at a table one row past the
    staged form's limit (PER_LANE_CASE), against its plain version."""
    n_rows, n, steps = PER_LANE_CASE
    rng = np.random.default_rng([eg.SEED, n_rows, n])
    table = rng.standard_normal((n_rows, 128)).astype(np.float32)
    table[:, 0] = rng.integers(0, n_rows, n_rows)
    idx = torch.from_numpy(rng.integers(0, n_rows, n).astype(np.int32)).to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        t = torch.from_numpy(table).to(dev).to(dtype)
        check(not gk.chase_staged(n_rows, n, steps), "phase 8: the per-lane case would run staged")
        before = gk.launch_counts()
        got = gk.row_chase(t, idx, steps)
        check(gk.launch_counts()["row_chase_staged"] == before["row_chase_staged"],
              "phase 8: the per-lane case ran staged")
        check(torch.equal(got, gk.row_chase_plain(t, idx, steps)),
              f"phase 8 per-lane chase R={n_rows} {dtype}: the kernel disagrees with its plain version")
        log(f"phase 8 per-lane chase R={n_rows} N={n} K={steps} {dtype}: equal, "
            f"{eg.time_ms(lambda: gk.row_chase(t, idx, steps), dev):.5f} ms")


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
        # with the plain version (row 15's chain alone, a kernel of its
        # own, in chain_launches).
        timed = sum(r["launches"] for r in rows.values() if r["kernel"] == kernel) + sum(
            r["chain_launches"] for r in rows.values()
            if r.get("chain_kernel") == kernel != r["kernel"])
        check(timed > 0, f"phase 9: the {kernel} kernel was not launched")
        check(launches[kernel] > timed, f"phase 9: {kernel} launched {launches[kernel]} times, "
                                        f"its cases timed {timed}")
    smi = nvidia_smi_line()
    log(f"phase 9 entry point: {len(rows)} cases in {seconds:.1f}s, launches {json.dumps(launches)}")
    attrib_patterned(dev, tables)
    for name, res in rows.items():
        keys = ("ns_per_step", "ns_per_step_per_program", "marginal_ns", "ms", "chain_ms",
                "chain_plain_ms", "chain_bound_ms", "chain_launches", "plain_ms", "bound_ms",
                "bound_by", "bytes", "ops", "launches", "max_abs_err")
        line = {k: res[k] for k in keys if k in res}
        line["steps"] = {s: {k: p[k] for k in ("ms", "chain_ms", "plain_ms", "checksum", "mu",
                                                "lam", "distinct") if k in p}
                         for s, p in res["steps"].items()}
        log(f"phase 9 case {name} [{smi}]: {json.dumps(line)}")
    for name, res in rows.items():
        if res["kernel"] == "step_ablate":
            log(f"phase 9 {name} chain: " + "; ".join(
                f"{s} steps mu {p['mu']} lambda {p['lam']} distinct rows {p['distinct']}"
                for s, p in res["steps"].items()))
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
    # Row 15's chain alone, a kernel of its own (timed beside each variant;
    # its line carries the full variant's case).
    res = rows[PACKET_ROWS["15"][1]]
    of_row = [r for r in rows.values() if r.get("chain_kernel") == "step_attrib_chain"]
    out["15 chain"] = {
        "name": "step_attrib_chain:row15",
        "route": "cuda",
        "source": PACKET_SOURCE,
        "replaces": "experiments/exp_step_attrib.py:43 (kern, its scalar chain: the pops "
                    ":151-162; pallas_call :208)",
        "launches": sum(r["chain_launches"] for r in of_row),
        "max_abs_err": 0.0,  # the visits are integers, held equal to the plain version's
        "ms": res["chain_ms"],
        "plain_ms": res["chain_plain_ms"],
        "bound_ms": res["chain_bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }
    log(f"phase 9 row 15 chain alone: {json.dumps(out['15 chain'])}")
    return out


def attrib_patterned(dev, tables):
    """Row 15 and its chain alone, every variant at the entry point's case,
    from a patterned stack (measure.patterned_stack) instead of interpret
    mode's INT32_MIN, against the plain versions: out, tri and the final
    stacks bit-equal, the pops and pushes landed."""
    for case in eps.cases():
        if case.kernel != "step_attrib":
            continue
        x = eps.make_inputs(case, dev, tables)
        size, n_rows = x["stack_size"], x["meta"].shape[0]
        k = eps.ATTRIB_PACKETS
        init = patterned_stack(n_rows, k, size, eps.SEED + 1).to(dev)
        args = (x["rows8"], x["meta"], x["rays"], case.variant, case.steps[-1], k, size, init)
        got, got_st = pk.step_attrib(*args)
        want, want_st = pk.step_attrib_plain(*args)
        chain = pk.step_attrib_chain(*args)
        chain_want = pk.step_attrib_chain_plain(x["meta"], case.variant, case.programs, k,
                                                case.steps[-1], size, init)
        check(torch.equal(got, want) and torch.equal(got_st, want_st),
              f"phase 9 {case.name}, patterned stack: the kernel disagrees with its plain version")
        check(torch.equal(chain, chain_want),
              f"phase 9 {case.name}, patterned stack: the chain disagrees with its plain version")
        if case.variant != "noscalar":
            check(not torch.equal(got_st[:, 1:3], init[:, 1:3]),
                  f"phase 9 {case.name}, patterned stack: no pop or push landed")
        log(f"phase 9 {case.name} patterned stack: equal; rows visited "
            f"{int(torch.unique(chain[:, :, 0]).numel())}, lanes that hit "
            f"{int((got[:, 1] >= 0).sum())}, stack slots 0-2 {got_st[:, :3].tolist()}")


def phase10(dev) -> dict:
    """The material bench scene: card against CPU on a small render, then
    the full render under v1."""
    t0 = time.perf_counter()
    scene_cpu, _, _ = build_material_bench_scene(BENCH_TRIS, BENCH_RESOLUTION, device="cpu")
    scene_gpu = scene_cpu.to(dev)
    log(f"phase 10 scene: {scene_cpu.triangles.orig_indices.shape[0]} triangles, material kinds "
        f"{list(scene_cpu.material_kinds)}, built in {time.perf_counter() - t0:.1f}s")
    del scene_cpu
    images, seconds = {}, {}
    t0 = time.perf_counter()
    images["gpu"] = small_bench_render(scene_gpu, "v1")
    seconds["gpu"] = time.perf_counter() - t0
    images["cpu"], seconds["cpu"] = cpu_image("p10")
    for dev_name, img in images.items():
        check(np.isfinite(img).all() and img.mean() > 0, f"phase 10: bad {dev_name} small image")
    agree = check_agreement("phase 10 small render", images["gpu"], images["cpu"])
    log(f"phase 10 small render {SMALL_RES[0]}x{SMALL_RES[1]} spp {SMALL_SPP}: "
        f"seconds {json.dumps(seconds)} {json.dumps(agree)}")
    res, _ = full_render(scene_gpu, "v1", "phase 10", spp=MATERIAL_SPP)
    res["small_render"] = agree
    res["card"] = nvidia_smi_line()
    log(f"phase 10 full render {BENCH_RESOLUTION[0]}x{BENCH_RESOLUTION[1]} spp {MATERIAL_SPP}: "
        f"{json.dumps(res)}")
    return res


# Phase 11: the committed golden scenes and tests/test_golden.py's
# tolerances (mean and 99th percentile of the absolute difference,
# relative to the golden's mean absolute value).
GOLDEN_DIR = Path("tests") / "scenes"
GOLDEN_SCENES = ("diffuse_box", "conductor_env", "dielectric")
GOLDEN_MEAN_REL, GOLDEN_P99_REL = 0.01, 0.05
LOADED_DIR = Path("chiprun_out") / "phase11"
LOADED_PLY = "bench_sphere.ply"


def golden_drift(img: np.ndarray, golden: np.ndarray) -> dict:
    scale = max(float(np.abs(golden).mean()), 1e-6)
    diff = np.abs(img - golden)
    return {"mean_rel": float(diff.mean() / scale),
            "p99_rel": float(np.quantile(diff, 0.99) / scale)}


def write_ply(path: Path, verts: np.ndarray, faces: np.ndarray):
    """Binary little-endian PLY: float32 x y z, uchar-counted int32 faces."""
    header = (f"ply\nformat binary_little_endian 1.0\nelement vertex {len(verts)}\n"
              "property float x\nproperty float y\nproperty float z\n"
              f"element face {len(faces)}\nproperty list uchar int vertex_indices\n"
              "end_header\n")
    face_rows = np.zeros(len(faces), np.dtype([("n", "u1"), ("v", "<i4", 3)]))
    face_rows["n"] = 3
    face_rows["v"] = faces
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(np.ascontiguousarray(verts, "<f4").tobytes())
        f.write(face_rows.tobytes())


def loaded_scene_text(res, spp: int) -> str:
    """The bench scene as a pbrt-v4 file: the bench camera, the sphere
    mesh from the PLY, the floor, the emissive quad and the infinite
    light, with three analytic spheres beside the mesh."""
    return f"""# The bench scene of bench.py as a scene file, with three analytic spheres.
LookAt 0 0.6 -3.2  0 0 0  0 1 0
Camera "perspective" "float fov" [40]
Film "rgb" "integer xresolution" [{res[0]}] "integer yresolution" [{res[1]}]
Sampler "zsobol" "integer pixelsamples" [{spp}]
Integrator "path" "integer maxdepth" [{MAX_DEPTH}]
PixelFilter "box"
WorldBegin
LightSource "infinite" "float scale" [0.3]
Material "diffuse" "rgb reflectance" [0.55 0.45 0.35]
Shape "plymesh" "string filename" "{LOADED_PLY}"
Material "diffuse" "rgb reflectance" [0.4 0.4 0.42]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point3 P" [-8 -1.3 -8  8 -1.3 -8  8 -1.3 8  -8 -1.3 8]
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [15 15 15]
  Material "diffuse" "rgb reflectance" [0 0 0]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
      "point3 P" [-1 4 -1  1 4 -1  1 4 1  -1 4 1]
AttributeEnd
AttributeBegin
  Material "dielectric" "float eta" [1.5]
  Translate -1.55 -0.8 -0.9
  Shape "sphere" "float radius" [0.5]
AttributeEnd
AttributeBegin
  Material "conductor" "spectrum eta" "metal-Au-eta" "spectrum k" "metal-Au-k"
      "float roughness" [0.08]
  Translate 1.55 -0.8 -0.9
  Shape "sphere" "float radius" [0.5]
AttributeEnd
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [40 36 30]
  Material "diffuse" "rgb reflectance" [0 0 0]
  Translate 0.6 1.5 -1.4
  Shape "sphere" "float radius" [0.12]
AttributeEnd
"""


def render_job(job):
    """Render a loaded job at its in-file settings; returns the image and
    the render's seconds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img, _ = render(job.scene, job.camera, job.film, job.sampler, spp=job.spp,
                    max_depth=job.max_depth, wave_spp=WAVE_SPP, pixel_block=BLOCK)
    torch.cuda.synchronize()
    return img, time.perf_counter() - t0


def small_job_render(job, scene, collect_stats: bool = False):
    """A loaded small job on ``scene`` (its copy on the card, or the CPU's)
    at its in-file settings, one wave of its samples a block."""
    return render(scene, job.camera, job.film, job.sampler, spp=job.spp,
                  max_depth=job.max_depth, wave_spp=SMALL_SPP, pixel_block=BLOCK,
                  collect_stats=collect_stats)


def render_through_cli(scene_file: Path, pfm: Path, timers: dict | None = None):
    """``cli.main`` on a scene file at the bench's wave and block sizes,
    with its own render call watched (its returned image and the stats the
    CLI does not ask for) and, for each name -> (owner, attribute) in
    ``timers``, the seconds spent in that function summed (and, for a name
    ending in ``_fits``, the colors fitted: its first argument's rows).  The
    launch counts are set to 0 just before.  Returns (seen, cli seconds, rc)."""
    real_render, seen = render_module.render, {"timers": {}, "colors_fitted": {}}

    def watched_render(*args, **kwargs):
        asked = kwargs.pop("collect_stats", False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        image, state, stats = real_render(*args, **kwargs, collect_stats=True)
        torch.cuda.synchronize()
        seen.update(image=image.cpu().numpy(), stats=stats, scene=args[0],
                    seconds=time.perf_counter() - t0)
        return (image, state, stats) if asked else (image, state)

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            if name.endswith("_fits"):
                fitted = seen["colors_fitted"]
                fitted[name] = fitted.get(name, 0) + len(args[0])
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                seen["timers"][name] = seen["timers"].get(name, 0.0) + time.perf_counter() - t0
        return wrapper

    patches = [(render_module, "render", watched_render)]
    for name, (owner, attr) in (timers or {}).items():
        fn = owner.__dict__[attr]
        wrapped = timed(name, fn.__func__ if isinstance(fn, staticmethod) else fn)
        patches.append((owner, attr, staticmethod(wrapped) if isinstance(fn, staticmethod)
                        else wrapped))
    saved = [(owner, attr, owner.__dict__[attr]) for owner, attr, _ in patches]
    for owner, attr, value in patches:
        setattr(owner, attr, value)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        rc = cli.main([str(scene_file), "--outfile", str(pfm), "--wave-spp", str(WAVE_SPP),
                       "--pixel-block", str(BLOCK), "--quiet", "--device", "cuda"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        for owner, attr, value in saved:
            setattr(owner, attr, value)
    seen["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    return seen, seconds, rc


def phase11(dev) -> dict:
    out = {"golden": {}}
    # (a) the golden scenes, parsed by the port's loader.
    for name in GOLDEN_SCENES:
        builder = SceneBuilder(search_dir=GOLDEN_DIR)
        parse_file(str(GOLDEN_DIR / f"{name}.pbrt"), builder)
        job = builder.create(device=dev, traverse=CONFIGS["v1"])
        reset_counts()
        img, seconds = render_job(job)
        launches = read_counts(f"phase 11 {name}", "v1")
        img = img.cpu().numpy()
        golden = np.load(GOLDEN_DIR / f"golden_{name}.npz")["image"]
        check(img.shape == golden.shape and np.isfinite(img).all(), f"phase 11 {name}: bad image")
        res = {**golden_drift(img, golden), "seconds": seconds, "kernel_launches": launches,
               "spheres": int(job.scene.spheres.radius.shape[0]), "spp": job.spp,
               "max_depth": job.max_depth}
        check(res["mean_rel"] < GOLDEN_MEAN_REL, f"phase 11 {name}: mean drift {res['mean_rel']}")
        check(res["p99_rel"] < GOLDEN_P99_REL, f"phase 11 {name}: p99 drift {res['p99_rel']}")
        log(f"phase 11 golden {name}: {json.dumps(res)}")
        out["golden"][name] = res

    # (b) the loaded scene at full width, through the CLI.
    LOADED_DIR.mkdir(parents=True, exist_ok=True)
    verts, faces = make_displaced_sphere(BENCH_TRIS)
    write_ply(LOADED_DIR / LOADED_PLY, verts, faces)
    scene_file = LOADED_DIR / "loaded_bench.pbrt"
    scene_file.write_text(loaded_scene_text(BENCH_RESOLUTION, LOADED_SPP))
    pfm = LOADED_DIR / "loaded_bench.pfm"
    seen, seconds, rc = render_through_cli(scene_file, pfm)
    launches = read_counts("phase 11 loaded scene", "v1")
    check(rc == 0, f"phase 11: the CLI returned {rc}")
    img = seen["image"]
    written = Image.read(pfm).data
    check(np.array_equal(written, img), "phase 11: the PFM differs from the rendered image")
    check(np.isfinite(img).all() and img.mean() > 0, "phase 11: bad loaded-scene image")
    scene = seen["scene"]
    stats = seen["stats"]
    res = {
        "triangles": int(scene.triangles.orig_indices.shape[0]),
        "spheres": int(scene.spheres.radius.shape[0]),
        "lights": scene.n_lights,
        "render_seconds": seen["seconds"],
        "cli_seconds": seconds,
        "rays": stats["rays"],
        "mrays_per_s": stats["rays"] / seen["seconds"] / 1e6,
        "iters": stats["iters"],
        "kernel_launches": launches,
        "peak_device_bytes": seen["peak_device_bytes"],
        "image_mean": float(img.mean()),
        "card": nvidia_smi_line(),
    }
    check(res["spheres"] == 3 and res["triangles"] == faces.shape[0] + 4,
          "phase 11: the loaded scene lacks shapes")
    log(f"phase 11 loaded scene {BENCH_RESOLUTION[0]}x{BENCH_RESOLUTION[1]} spp {LOADED_SPP} "
        f"(cli.main; cli_seconds add the parse, PLY read, BVH build and PFM write): "
        f"{json.dumps(res)}")
    out["loaded"] = res

    # The same file small, on the card and on the CPU.
    small = LOADED_DIR / "loaded_small.pbrt"
    small.write_text(loaded_scene_text(SMALL_RES, SMALL_SPP))
    job = load_case(small)
    images, seconds = {}, {}
    t0 = time.perf_counter()
    images["gpu"] = small_job_render(job, job.scene.to(dev))[0].cpu().numpy()
    seconds["gpu"] = time.perf_counter() - t0
    images["cpu"], seconds["cpu"] = cpu_image("p11")
    for dev_name, img in images.items():
        check(np.isfinite(img).all() and img.mean() > 0, f"phase 11: bad {dev_name} small image")
    agree = check_agreement("phase 11 small loaded render", images["gpu"], images["cpu"])
    log(f"phase 11 small loaded render {SMALL_RES[0]}x{SMALL_RES[1]} spp {SMALL_SPP}: "
        f"seconds {json.dumps(seconds)} {json.dumps(agree)}")
    out["small"] = agree
    return out


# Phase 12: textures and the image environment light, through the loader
# and the CLI, at the bench configuration.  The images are written as PFM
# (the card's machine has no PIL) with few colors at every MIP level, so
# the host's RGB fit (one fit per unique color) stays short: a checker
# with power-of-two cells (two colors, then their average), a gray sky
# (every gray texel fits as one color, whatever its brightness) with a
# warm sun, and two-color stripes.
TEXTURED_DIR = Path("chiprun_out") / "phase12"
# The images and the PLY, removed after the phase: chiprun_out/ must stay
# small enough to come back from the card's machine.
TEXTURE_FILES = ("checker.pfm", "rough.pfm", "stripes.pfm", "bumps.pfm", "amount.pfm",
                 "sky.pfm", LOADED_PLY)
CHECKER_RES, ROUGH_RES, SKY_SHAPE = 2048, 1024, (1024, 2048)
SKY_LEVELS = 200


def write_texture_files(d: Path):
    """The phase's images: checker.pfm (2048^2 RGB), rough.pfm (1024^2
    float), stripes.pfm (256x64 RGB), bumps.pfm (512^2 float), amount.pfm
    (256^2 float) and sky.pfm (2048x1024 lat-long, at most SKY_LEVELS + 1
    colors).  Returns the sky's count of distinct colors."""
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(12)
    yy, xx = np.mgrid[0:CHECKER_RES, 0:CHECKER_RES]
    cell = ((xx // 64 + yy // 64) % 2).astype(bool)
    checker = np.where(cell[..., None], np.float32([0.8, 0.75, 0.7]),
                       np.float32([0.15, 0.2, 0.3])).astype(np.float32)
    Image(checker).write(d / "checker.pfm")
    yy, xx = np.mgrid[0:ROUGH_RES, 0:ROUGH_RES] / ROUGH_RES
    rough = 0.05 + 0.2 * (1.0 + np.sin(40.0 * xx) * np.cos(23.0 * yy))
    Image(rough.astype(np.float32)).write(d / "rough.pfm")
    stripes = np.where((np.arange(256) // 16 % 2).astype(bool)[None, :, None],
                       np.float32([0.7, 0.2, 0.1]), np.float32([0.1, 0.3, 0.6]))
    Image(np.broadcast_to(stripes, (64, 256, 3)).astype(np.float32)).write(d / "stripes.pfm")
    Image(rng.uniform(0.0, 1.0, (512, 512)).astype(np.float32)).write(d / "bumps.pfm")
    Image(rng.uniform(0.0, 1.0, (256, 256)).astype(np.float32)).write(d / "amount.pfm")
    h, w = SKY_SHAPE
    theta = (np.arange(h) + 0.5) / h * np.pi
    level = np.round((0.15 + 0.85 * np.sin(theta) ** 4) * SKY_LEVELS) / SKY_LEVELS
    sky = np.repeat(np.repeat(level[:, None, None], w, 1), 3, 2).astype(np.float32) * 0.8
    yy, xx = np.mgrid[0:h, 0:w]
    sun = (yy - 0.3 * h) ** 2 + (xx - 0.6 * w) ** 2 < (0.015 * h) ** 2
    sky[sun] = [40.0, 32.0, 22.0]
    Image(sky).write(d / "sky.pfm")
    return int(np.unique(sky.reshape(-1, 3), axis=0).shape[0])


def textured_scene_text(res, spp: int) -> str:
    """Phase 11's scene file with textures and an image environment light
    in place of the uniform one: the floor a 2048^2 checker (trilinear,
    uv), the mesh a coated diffuse with cylindrical stripes and a bump
    map, the gold sphere's roughness a 1024^2 EWA map through a scale
    texture, the glass sphere a mix of that gold and a direction-mix
    diffuse with a textured amount."""
    return f"""# Phase 11's scene with textures and an image environment light.
LookAt 0 0.6 -3.2  0 0 0  0 1 0
Camera "perspective" "float fov" [40]
Film "rgb" "integer xresolution" [{res[0]}] "integer yresolution" [{res[1]}]
Sampler "zsobol" "integer pixelsamples" [{spp}]
Integrator "path" "integer maxdepth" [{MAX_DEPTH}]
PixelFilter "box"
WorldBegin
AttributeBegin
  Rotate -90 1 0 0
  LightSource "infinite" "string filename" "sky.pfm" "float scale" [0.6]
AttributeEnd
Texture "checks" "spectrum" "imagemap" "string filename" "checker.pfm"
    "string filter" "trilinear" "float uscale" [4] "float vscale" [4]
Texture "rough" "float" "imagemap" "string filename" "rough.pfm" "string filter" "ewa"
Texture "half" "float" "constant" "float value" [0.5]
Texture "gold_rough" "float" "scale" "texture tex" "rough" "texture scale" "half"
Texture "stripes" "spectrum" "imagemap" "string filename" "stripes.pfm"
    "string mapping" "cylindrical" "string filter" "bilinear"
Texture "bumps" "float" "imagemap" "string filename" "bumps.pfm" "float scale" [0.002]
Texture "amount" "float" "imagemap" "string filename" "amount.pfm" "string filter" "bilinear"
Texture "tint" "spectrum" "directionmix" "rgb tex1" [0.7 0.2 0.2] "rgb tex2" [0.2 0.3 0.8]
    "vector3 dir" [0 1 0]
MakeNamedMaterial "gold" "string type" "conductor" "spectrum eta" "metal-Au-eta"
    "spectrum k" "metal-Au-k" "texture roughness" "gold_rough"
MakeNamedMaterial "tinted" "string type" "diffuse" "texture reflectance" "tint"
Material "coateddiffuse" "texture reflectance" "stripes" "texture displacement" "bumps"
    "float roughness" [0.05]
Shape "plymesh" "string filename" "{LOADED_PLY}"
Material "diffuse" "texture reflectance" "checks"
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point3 P" [-8 -1.3 -8  8 -1.3 -8  8 -1.3 8  -8 -1.3 8] "point2 uv" [0 0 1 0 1 1 0 1]
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [15 15 15]
  Material "diffuse" "rgb reflectance" [0 0 0]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
      "point3 P" [-1 4 -1  1 4 -1  1 4 1  -1 4 1]
AttributeEnd
AttributeBegin
  Material "mix" "string materials" ["gold" "tinted"] "texture amount" "amount"
  Translate -1.55 -0.8 -0.9
  Shape "sphere" "float radius" [0.5]
AttributeEnd
AttributeBegin
  NamedMaterial "gold"
  Translate 1.55 -0.8 -0.9
  Shape "sphere" "float radius" [0.5]
AttributeEnd
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [40 36 30]
  Material "diffuse" "rgb reflectance" [0 0 0]
  Translate 0.6 1.5 -1.4
  Shape "sphere" "float radius" [0.12]
AttributeEnd
"""


def phase12(dev) -> dict:
    try:
        return _phase12(dev)
    finally:
        for name in TEXTURE_FILES:
            (TEXTURED_DIR / name).unlink(missing_ok=True)


def _phase12(dev) -> dict:
    from shimmer_tpu_torch.lights import env as env_module
    from shimmer_tpu_torch.shapes import mesh as mesh_module
    from shimmer_tpu_torch.shapes import triangle as triangle_module
    from shimmer_tpu_torch.textures import textures as textures_module
    from shimmer_tpu_torch.textures.textures import TextureBuilder

    out = {}
    t0 = time.perf_counter()
    sky_colors = write_texture_files(TEXTURED_DIR)
    verts, faces = make_displaced_sphere(BENCH_TRIS)
    write_ply(TEXTURED_DIR / LOADED_PLY, verts, faces)
    log(f"phase 12 files: {time.perf_counter() - t0:.1f}s; sky {SKY_SHAPE[1]}x{SKY_SHAPE[0]} "
        f"with {sky_colors} colors")
    scene_file = TEXTURED_DIR / "textured_bench.pbrt"
    scene_file.write_text(textured_scene_text(BENCH_RESOLUTION, LOADED_SPP))
    pfm = TEXTURED_DIR / "textured_bench.pfm"
    timers = {
        "image_read": (Image, "read"),
        "texture_add_image": (TextureBuilder, "add_image"),
        "texture_pyramids": (Image, "generate_pyramid"),
        "texture_fits": (textures_module, "fit_rgb_coeffs"),
        "texture_upload": (TextureBuilder, "build"),
        "env_bake": (env_module, "build_env_light"),
        "env_fits": (env_module, "fit_rgb_coeffs"),
        "ply_read": (mesh_module, "read_ply"),
        "bvh_build": (triangle_module, "build_triangle_scene"),
    }
    # Timers that run inside another timer: name -> the one that holds it.
    nested = {"texture_pyramids": "texture_add_image", "texture_fits": "texture_add_image",
              "env_fits": "env_bake"}
    seen, seconds, rc = render_through_cli(scene_file, pfm, timers)
    launches = read_counts("phase 12 textured scene", "v1")
    check(rc == 0, f"phase 12: the CLI returned {rc}")
    img = seen["image"]
    check(np.array_equal(Image.read(pfm).data, img), "phase 12: the PFM differs from the image")
    check(np.isfinite(img).all() and img.mean() > 0, "phase 12: bad textured-scene image")
    scene = seen["scene"]
    stats = seen["stats"]
    spent = seen["timers"]
    load = {k: round(v, 3) for k, v in spent.items()}
    # What each holding timer spent outside the timers it holds: add_image's
    # np.unique of the colors and its atlas packing; the env bake's resample,
    # np.unique and distribution build.
    for outer in set(nested.values()):
        inner = sum(spent.get(k, 0.0) for k, o in nested.items() if o == outer)
        load[f"{outer}_rest"] = round(spent.get(outer, 0.0) - inner, 3)
    # The rest of the CLI's time: the parse, the scene tables, the PFM write.
    top = sum(v for k, v in spent.items() if k not in nested)
    load["parse_and_the_rest"] = round(seconds - seen["seconds"] - top, 3)
    res = {
        "triangles": int(scene.triangles.orig_indices.shape[0]),
        "spheres": int(scene.spheres.radius.shape[0]),
        "lights": scene.n_lights,
        "textures": int(scene.textures.kind.shape[0]),
        "atlas_texels": int(scene.textures.atlas.shape[0]),
        "env_res": list(scene.env.texel_scale.shape),
        "load_seconds": load,
        "colors_fitted": seen["colors_fitted"],
        "render_seconds": seen["seconds"],
        "cli_seconds": seconds,
        "rays": stats["rays"],
        "mrays_per_s": stats["rays"] / seen["seconds"] / 1e6,
        "iters": stats["iters"],
        "kernel_launches": launches,
        "peak_device_bytes": seen["peak_device_bytes"],
        "image_mean": float(img.mean()),
        "card": nvidia_smi_line(),
    }
    check(res["spheres"] == 3 and res["triangles"] == faces.shape[0] + 4
          and scene.image_infinite_indices and scene.has_bump_maps,
          "phase 12: the textured scene lacks shapes, its env light or its bump map")
    log(f"phase 12 textured scene {BENCH_RESOLUTION[0]}x{BENCH_RESOLUTION[1]} spp {LOADED_SPP} "
        f"(cli.main): {json.dumps(res)}")
    out["textured"] = res

    # The same file small: the card against the CPU, and the card twice.
    small = TEXTURED_DIR / "textured_small.pbrt"
    small.write_text(textured_scene_text(SMALL_RES, SMALL_SPP))
    job = load_case(small)
    scene_gpu = job.scene.to(dev)
    images, seconds, states = {}, {}, []
    for dev_name in ("gpu", "gpu_again"):
        t0 = time.perf_counter()
        img, state = small_job_render(job, scene_gpu)
        images[dev_name] = img.cpu().numpy()
        seconds[dev_name] = time.perf_counter() - t0
        states.append(state)
    images["cpu"], seconds["cpu"] = cpu_image("p12")
    for dev_name, img in images.items():
        check(np.isfinite(img).all() and img.mean() > 0, f"phase 12: bad {dev_name} small image")
    agree = check_agreement("phase 12 small textured render", images["gpu"], images["cpu"])
    # The film accumulates on the card by scatter-add: two renders must give
    # the same film state, bit for bit.
    film_equal = all(torch.equal(getattr(states[0], f), getattr(states[1], f))
                     for f in ("rgb_sum", "weight_sum", "rgb_splat"))
    check(film_equal, "phase 12: two card renders gave different film states")
    log(f"phase 12 small textured render {SMALL_RES[0]}x{SMALL_RES[1]} spp {SMALL_SPP}: "
        f"seconds {json.dumps(seconds)} {json.dumps(agree)}; two card renders: film states "
        f"torch.equal")
    out["small"] = agree
    return out


# Phase 13: delta lights and homogeneous media, through the loader and the
# CLI, at the bench configuration: phase 11's scene in an exterior fog
# (the camera's medium), with a box of interface material holding a
# denser smoke around the bench sphere, and a point, a spot and a distant
# light.  The interface scene traces four times an iteration (the merged
# trace, then three shadow-march rounds); the exterior-only variant once.
MEDIA_DIR = Path("chiprun_out") / "phase13"
# Removed after the phase, as phase 12's: the PLY and the images.
MEDIA_FILES = (LOADED_PLY, "fog_bench.pfm")
FOG_SIGMA_A, FOG_SIGMA_S = 0.03, 0.12
# The box (half-width 1.15, turned 45 degrees about y, so that the glass
# and gold spheres stay outside it) and its faces, outward.
BOX_LO, BOX_HI = (-1.15, -1.25, -1.15), (1.15, 1.2, 1.15)
_BOX_FACES = [(0, 2, 3, 1), (4, 5, 7, 6), (0, 1, 5, 4), (2, 6, 7, 3), (0, 4, 6, 2), (1, 3, 7, 5)]
MEDIA_VARIANTS = ("interface", "exterior", "delta")


def box_mesh_text(lo, hi) -> str:
    """A 12-triangle box with outward normals as a trianglemesh."""
    lo, hi = np.asarray(lo, float), np.asarray(hi, float)
    p = np.array([[hi[0] if i & 1 else lo[0], hi[1] if i & 2 else lo[1],
                   hi[2] if i & 4 else lo[2]] for i in range(8)])
    idx = []
    for a, b, c, d in _BOX_FACES:
        for tri in ((a, b, c), (a, c, d)):
            n = np.cross(p[tri[1]] - p[tri[0]], p[tri[2]] - p[tri[0]])
            outward = n @ (p[list(tri)].mean(0) - (lo + hi) / 2) > 0
            idx.extend(tri if outward else tri[::-1])
    pts = " ".join(f"{x:g}" for x in p.ravel())
    return (f'Shape "trianglemesh" "integer indices" [{" ".join(map(str, idx))}]\n'
            f'      "point3 P" [{pts}]')


def fog_transmittance_to_floor() -> float:
    """The fog's transmittance from the camera to the floor along the ray
    through the bottom centre of the image (fov 40 on the image's height,
    camera at (0, 0.6, -3.2) looking at the origin, floor at y = -1.3)."""
    below = np.arctan2(0.6, 3.2) + np.deg2rad(20.0)
    return float(np.exp(-(FOG_SIGMA_A + FOG_SIGMA_S) * (0.6 + 1.3) / np.sin(below)))


def media_scene_text(res, spp: int, variant: str = "interface") -> str:
    """Phase 11's scene with a point, a spot and a distant light; the
    ``interface`` variant in an exterior fog with the smoke box around the
    bench sphere, ``exterior`` in the fog alone, ``delta`` without media."""
    fog = variant in ("interface", "exterior")
    media = f"""MakeNamedMedium "fog" "string type" "homogeneous"
    "rgb sigma_a" [{FOG_SIGMA_A} {FOG_SIGMA_A} {FOG_SIGMA_A}]
    "rgb sigma_s" [{FOG_SIGMA_S} {FOG_SIGMA_S} {FOG_SIGMA_S}] "float g" [0.2]
MakeNamedMedium "smoke" "string type" "homogeneous" "rgb sigma_a" [0.15 0.2 0.3]
    "rgb sigma_s" [0.9 0.9 0.9] "float g" [0.6]
MediumInterface "" "fog"
""" if fog else ""
    box = f"""AttributeBegin
  Rotate 45 0 1 0
  MediumInterface "smoke" "fog"
  Material "interface"
  {box_mesh_text(BOX_LO, BOX_HI)}
AttributeEnd
""" if variant == "interface" else ""
    return f"""# Phase 11's scene with delta lights ({variant}).
{media}LookAt 0 0.6 -3.2  0 0 0  0 1 0
Camera "perspective" "float fov" [40]
Film "rgb" "integer xresolution" [{res[0]}] "integer yresolution" [{res[1]}]
Sampler "zsobol" "integer pixelsamples" [{spp}]
Integrator "volpath" "integer maxdepth" [{MAX_DEPTH}]
PixelFilter "box"
WorldBegin
{'MediumInterface "" ""' if fog else ""}
LightSource "infinite" "float scale" [0.3]
LightSource "point" "point3 from" [-2 2.5 -2] "rgb I" [10 10 10]
LightSource "spot" "point3 from" [2.5 3.5 -2.5] "point3 to" [0 0 0] "blackbody I" [3000]
    "float coneangle" [25] "float conedeltaangle" [5] "float scale" [30]
LightSource "distant" "point3 from" [0 1 0] "point3 to" [-0.3 0 0.2] "rgb L" [1.5 1.4 1.2]
Material "diffuse" "rgb reflectance" [0.55 0.45 0.35]
Shape "plymesh" "string filename" "{LOADED_PLY}"
Material "diffuse" "rgb reflectance" [0.4 0.4 0.42]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point3 P" [-8 -1.3 -8  8 -1.3 -8  8 -1.3 8  -8 -1.3 8]
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [15 15 15]
  Material "diffuse" "rgb reflectance" [0 0 0]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
      "point3 P" [-1 4 -1  1 4 -1  1 4 1  -1 4 1]
AttributeEnd
{box}AttributeBegin
  Material "dielectric" "float eta" [1.5]
  Translate -1.55 -0.8 -0.9
  Shape "sphere" "float radius" [0.5]
AttributeEnd
AttributeBegin
  Material "conductor" "spectrum eta" "metal-Au-eta" "spectrum k" "metal-Au-k"
      "float roughness" [0.08]
  Translate 1.55 -0.8 -0.9
  Shape "sphere" "float radius" [0.5]
AttributeEnd
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [40 36 30]
  Material "diffuse" "rgb reflectance" [0 0 0]
  Translate 0.6 1.5 -1.4
  Shape "sphere" "float radius" [0.12]
AttributeEnd
"""


def phase13(dev) -> dict:
    try:
        return _phase13(dev)
    finally:
        for name in MEDIA_FILES:
            (MEDIA_DIR / name).unlink(missing_ok=True)


def _phase13(dev) -> dict:
    from shimmer_tpu_torch import media as media_module
    from shimmer_tpu_torch.shapes import mesh as mesh_module
    from shimmer_tpu_torch.shapes import triangle as triangle_module

    out = {}
    MEDIA_DIR.mkdir(parents=True, exist_ok=True)
    verts, faces = make_displaced_sphere(BENCH_TRIS)
    write_ply(MEDIA_DIR / LOADED_PLY, verts, faces)
    fog_tr = fog_transmittance_to_floor()
    check(0.3 <= fog_tr <= 0.7, f"phase 13: the fog's camera-to-floor transmittance is {fog_tr}")
    # (a) the interface scene at full width, through the CLI.
    scene_file = MEDIA_DIR / "fog_bench.pbrt"
    scene_file.write_text(media_scene_text(BENCH_RESOLUTION, LOADED_SPP))
    pfm = MEDIA_DIR / "fog_bench.pfm"
    timers = {"media_fits": (media_module, "fit_rgb_coeffs"),
              "ply_read": (mesh_module, "read_ply"),
              "bvh_build": (triangle_module, "build_triangle_scene")}
    seen, seconds, rc = render_through_cli(scene_file, pfm, timers)
    launches = read_counts("phase 13 fogged scene", "v1")
    check(rc == 0, f"phase 13: the CLI returned {rc}")
    img = seen["image"]
    check(np.array_equal(Image.read(pfm).data, img), "phase 13: the PFM differs from the image")
    check(np.isfinite(img).all() and img.mean() > 0, "phase 13: bad fogged-scene image")
    scene, stats = seen["scene"], seen["stats"]
    check(scene.has_interface_media and scene.camera_medium >= 0
          and set(scene.light_kinds) == {0, 1, 2, 3, 4},
          "phase 13: the scene lacks its media or its delta lights")
    iters = int(stats["iters"])
    check(launches == 4 * iters,
          f"phase 13: {launches} v1 launches in {iters} iterations, not 4 an iteration")
    load = {k: round(v, 3) for k, v in seen["timers"].items()}
    load["parse_and_the_rest"] = round(seconds - seen["seconds"] - sum(seen["timers"].values()),
                                       3)
    res = {
        "triangles": int(scene.triangles.orig_indices.shape[0]),
        "spheres": int(scene.spheres.radius.shape[0]),
        "lights": scene.n_lights,
        "media": int(scene.media.g.shape[0]),
        "fog_transmittance_to_floor": fog_tr,
        "load_seconds": load,
        "colors_fitted": seen["colors_fitted"],
        "render_seconds": seen["seconds"],
        "cli_seconds": seconds,
        "rays": stats["rays"],
        "mrays_per_s": stats["rays"] / seen["seconds"] / 1e6,
        "iters": stats["iters"],
        "ms_per_iter": 1e3 * seen["seconds"] / max(iters, 1),
        "kernel_launches": launches,
        "launches_per_iter": launches / max(iters, 1),
        "peak_device_bytes": seen["peak_device_bytes"],
        "image_mean": float(img.mean()),
        "card": nvidia_smi_line(),
    }
    check(res["spheres"] == 3 and res["triangles"] == faces.shape[0] + 4 + 12,
          "phase 13: the fogged scene lacks shapes")
    log(f"phase 13 fogged scene {BENCH_RESOLUTION[0]}x{BENCH_RESOLUTION[1]} spp {LOADED_SPP} "
        f"(cli.main): {json.dumps(res)}")
    out["fogged"] = res

    # (b) each variant small: the card against the CPU.
    for variant in MEDIA_VARIANTS:
        small = MEDIA_DIR / f"{variant}_small.pbrt"
        small.write_text(media_scene_text(SMALL_RES, SMALL_SPP, variant))
        job = load_case(small)
        check(job.scene.has_interface_media == (variant == "interface")
              and (job.scene.media is None) == (variant == "delta"),
              f"phase 13 {variant}: the scene's media census is wrong")
        images, secs = {}, {}
        sc = job.scene.to(dev)
        reset_counts()
        t0 = time.perf_counter()
        img, _, st = small_job_render(job, sc, collect_stats=True)
        images["gpu"] = img.cpu().numpy()
        secs["gpu"] = time.perf_counter() - t0
        n = read_counts(f"phase 13 small {variant}", "v1")
        # The merged trace, and three march rounds with interface media.
        per_iter = 4 if variant == "interface" else 1
        check(n == per_iter * int(st["iters"]),
              f"phase 13 small {variant}: {n} v1 launches in {st['iters']} iterations")
        card = {"iters": st["iters"], "rays": st["rays"], "kernel_launches": n}
        images["cpu"], secs["cpu"] = cpu_image(f"p13_{variant}")
        for dev_name, img in images.items():
            check(np.isfinite(img).all() and img.mean() > 0,
                  f"phase 13: bad {dev_name} small {variant} image")
        agree = check_agreement(f"phase 13 small {variant} render", images["gpu"], images["cpu"])
        log(f"phase 13 small {variant} render {SMALL_RES[0]}x{SMALL_RES[1]} spp {SMALL_SPP}: "
            f"seconds {json.dumps(secs)} card {json.dumps(card)} {json.dumps(agree)}")
        out[variant] = agree
    return out


# Phase 14: bilinear patches and two-level instancing, through the loader
# and the CLI, at the bench configuration.
INSTANCED_DIR = Path("chiprun_out") / "phase14"
# Removed after the phase, as phase 13's: the PLY and the image.
INSTANCED_FILES = (LOADED_PLY, "instanced_bench.pfm")
# Phase 14's full render runs at 4 spp, not the bench's 16: the instanced
# leg's plain tensor loop made it 241 s at 16 (~0.63 s a trace), which
# would take the whole run past ~1,000 s.
INSTANCED_SPP = 4
N_INSTANCES = 24
WALL_GRID = 4   # the back wall's patches a side
# tests/test_parser.py::TestCreate::test_instanced_scene_renders and
# ::TestBilinearMesh::test_bilinearmesh_parses_to_patches at their in-file
# sizes, with the zsobol sampler in place of the independent one (the port
# has no other sampler yet).
PARSER_SCENES = {
    "test_instanced_scene_renders": """
Film "rgb" "integer xresolution" [12] "integer yresolution" [12]
Sampler "zsobol" "integer pixelsamples" [2]
Integrator "path" "integer maxdepth" [2]
Camera "perspective" "float fov" [50]
WorldBegin
Material "diffuse" "rgb reflectance" [0.6 0.6 0.6]
ObjectBegin "blade"
  Shape "trianglemesh"
    "integer indices" [0 1 2  0 2 3]
    "point3 P" [-0.4 0 2  0.4 0 2  0.4 0.8 2  -0.4 0.8 2]
ObjectEnd
ObjectInstance "blade"
Translate 1 0 0
ObjectInstance "blade"
Translate -2 0 0
ObjectInstance "blade"
LightSource "infinite" "rgb L" [0.5 0.5 0.5]
""",
    "test_bilinearmesh_parses_to_patches": """
Film "rgb" "integer xresolution" [16] "integer yresolution" [16]
Sampler "zsobol" "integer pixelsamples" [2]
Integrator "path" "integer maxdepth" [2]
Camera "perspective" "float fov" [45]
WorldBegin
Material "diffuse" "rgb reflectance" [0.5 0.5 0.5]
Shape "bilinearmesh"
    "integer indices" [0 1 2 3]
    "point3 P" [-1 -1 2   1 -1 2   -1 1 2   1 1 2]
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [5 5 5]
  Shape "bilinearmesh"
      "integer indices" [0 1 2 3]
      "point3 P" [-0.5 2 -0.5  0.5 2 -0.5  -0.5 2 0.5  0.5 2 0.5]
AttributeEnd
LightSource "infinite" "rgb L" [0.2 0.2 0.2]
""",
}


def instance_placements() -> list[tuple[float, float, float, float]]:
    """(x, z, scale, degrees about y) of the 24 balls: two rings around
    the bench sphere, on an arc that leaves the camera's side open."""
    out = []
    for i in range(N_INSTANCES):
        r = 1.9 if i % 2 == 0 else 2.8
        theta = np.deg2rad(-130.0 + i * 260.0 / (N_INSTANCES - 1))
        scale = 0.15 + 0.2 * ((7 * i) % N_INSTANCES) / (N_INSTANCES - 1)
        out.append((r * np.sin(theta), r * np.cos(theta), scale, 15.0 * i))
    return out


def wall_patch_text() -> str:
    """The back wall: a WALL_GRID x WALL_GRID bilinearmesh whose vertices
    alternate 0.3 in front of and behind z = 3.2, so every patch is
    twisted, with uvs over the grid."""
    k = WALL_GRID + 1
    pts, uvs, idx = [], [], []
    for j in range(k):
        for i in range(k):
            pts.append((-4.5 + 9.0 * i / WALL_GRID, -1.3 + 4.5 * j / WALL_GRID,
                        3.2 + 0.3 * (-1) ** (i + j)))
            uvs.append((i / WALL_GRID, j / WALL_GRID))
    for j in range(WALL_GRID):
        for i in range(WALL_GRID):
            v = j * k + i
            idx.extend((v, v + 1, v + k, v + k + 1))
    return (f'Shape "bilinearmesh" "integer indices" [{" ".join(map(str, idx))}]\n'
            f'      "point3 P" [{" ".join(f"{x:g}" for p in pts for x in p)}]\n'
            f'      "point2 uv" [{" ".join(f"{x:g}" for p in uvs for x in p)}]')


def instanced_scene_text(res, spp: int) -> str:
    """Phase 11's camera, infinite light and bench sphere (world
    triangles), 24 instances of an object holding the same PLY and a
    small glass sphere, a planar patch floor, a twisted patch wall under a
    conductor, and a patch quad light beside the triangle quad light."""
    instances = "\n".join(
        f"AttributeBegin\n  Translate {x:.4f} {-1.3 + s:.4f} {z:.4f}\n  Rotate {a:g} 0 1 0\n"
        f"  Scale {s:.4f} {s:.4f} {s:.4f}\n  ObjectInstance \"ball\"\nAttributeEnd"
        for x, z, s, a in instance_placements())
    return f"""# Phase 11's scene with instances, patches and a patch light.
LookAt 0 0.6 -3.2  0 0 0  0 1 0
Camera "perspective" "float fov" [40]
Film "rgb" "integer xresolution" [{res[0]}] "integer yresolution" [{res[1]}]
Sampler "zsobol" "integer pixelsamples" [{spp}]
Integrator "path" "integer maxdepth" [{MAX_DEPTH}] "string lightsampler" "power"
PixelFilter "box"
WorldBegin
LightSource "infinite" "float scale" [0.3]
Material "diffuse" "rgb reflectance" [0.55 0.45 0.35]
Shape "plymesh" "string filename" "{LOADED_PLY}"
ObjectBegin "ball"
  Material "diffuse" "rgb reflectance" [0.3 0.5 0.6]
  Shape "plymesh" "string filename" "{LOADED_PLY}"
  AttributeBegin
    Material "dielectric" "float eta" [1.5]
    Translate 0 1.45 0
    Shape "sphere" "float radius" [0.3]
  AttributeEnd
ObjectEnd
{instances}
Material "diffuse" "rgb reflectance" [0.4 0.4 0.42]
Shape "bilinearmesh" "integer indices" [0 1 2 3]
    "point3 P" [-8 -1.3 -8  8 -1.3 -8  -8 -1.3 8  8 -1.3 8]
AttributeBegin
  Material "conductor" "spectrum eta" "metal-Cu-eta" "spectrum k" "metal-Cu-k"
      "float roughness" [0.1]
  {wall_patch_text()}
AttributeEnd
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [15 15 15]
  Material "diffuse" "rgb reflectance" [0 0 0]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
      "point3 P" [-1 4 -1  1 4 -1  1 4 1  -1 4 1]
AttributeEnd
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [20 18 15]
  Material "diffuse" "rgb reflectance" [0 0 0]
  Shape "bilinearmesh" "integer indices" [0 1 2 3]
      "point3 P" [-2.2 3 -0.6  -1.2 3 -0.6  -2.2 3 0.4  -1.2 3 0.4]
AttributeEnd
"""


def instanced_small_cases(d: Path) -> dict:
    """Phase 14's small scene files, written into ``d`` (which holds the
    PLY): the instanced scene at SMALL_RES, SMALL_SPP and the parser
    scenes; name -> file."""
    small = d / "instanced_small.pbrt"
    small.write_text(instanced_scene_text(SMALL_RES, SMALL_SPP))
    cases = {"instanced_small": small}
    for name, text in PARSER_SCENES.items():
        cases[name] = d / f"{name}.pbrt"
        cases[name].write_text(text)
    return cases


def card_events(owner, attr: str, events: list):
    """Replace ``owner.attr`` by a wrapper that records a CUDA event pair
    around each call (no host sync); returns the original."""
    fn = getattr(owner, attr)

    def wrapped(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        events.append((start, end))
        return out

    setattr(owner, attr, wrapped)
    return fn


def phase14(dev) -> dict:
    try:
        return _phase14(dev)
    finally:
        for name in INSTANCED_FILES:
            (INSTANCED_DIR / name).unlink(missing_ok=True)


def _phase14(dev) -> dict:
    from shimmer_tpu_torch import scene as scene_module
    from shimmer_tpu_torch import scene_builder as scene_builder_module
    from shimmer_tpu_torch.shapes import instanced as instanced_module
    from shimmer_tpu_torch.shapes import mesh as mesh_module
    from shimmer_tpu_torch.shapes import triangle as triangle_module

    out = {}
    INSTANCED_DIR.mkdir(parents=True, exist_ok=True)
    verts, faces = make_displaced_sphere(BENCH_TRIS)
    write_ply(INSTANCED_DIR / LOADED_PLY, verts, faces)
    # (a) the instanced, patch-lit scene at full width, through the CLI,
    # with the instanced and patch legs timed by CUDA events and the
    # instanced loop's steps recorded per trace.
    scene_file = INSTANCED_DIR / "instanced_bench.pbrt"
    scene_file.write_text(instanced_scene_text(BENCH_RESOLUTION, INSTANCED_SPP))
    pfm = INSTANCED_DIR / "instanced_bench.pfm"
    timers = {"ply_read": (mesh_module, "read_ply"),
              "object_bvh": (instanced_module, "_pack_object"),
              "instanced_build": (instanced_module, "build_instanced"),
              "world_bvh": (triangle_module, "build_triangle_scene"),
              "patch_table": (scene_builder_module, "make_bilinear_data")}
    inst_events, patch_events = [], []
    real_inst = card_events(scene_module, "instanced_intersect", inst_events)
    real_patch = card_events(scene_module, "bilinear_intersect", patch_events)
    instanced_module._traverse_inst.steps = []
    try:
        seen, seconds, rc = render_through_cli(scene_file, pfm, timers)
        steps = list(instanced_module._traverse_inst.steps)
    finally:
        scene_module.instanced_intersect = real_inst
        scene_module.bilinear_intersect = real_patch
        instanced_module._traverse_inst.steps = None
    launches = read_counts("phase 14 instanced scene", "v1")
    check(rc == 0, f"phase 14: the CLI returned {rc}")
    img = seen["image"]
    check(np.array_equal(Image.read(pfm).data, img), "phase 14: the PFM differs from the image")
    check(np.isfinite(img).all() and img.mean() > 0, "phase 14: bad instanced-scene image")
    scene, stats = seen["scene"], seen["stats"]
    iters = int(stats["iters"])
    check(launches == iters,
          f"phase 14: {launches} v1 launches in {iters} iterations, not one an iteration")
    inst = scene.instanced
    n_obj_tris = int(inst.attr_rows.shape[0])
    check(scene.has_patches and scene.has_instanced and scene.has_triangles
          and int(inst.inst_fwd.shape[0]) == N_INSTANCES and n_obj_tris == faces.shape[0]
          and int(scene.patches.p00.shape[0]) == WALL_GRID ** 2 + 2
          and int(scene.spheres.radius.shape[0]) == N_INSTANCES
          and int(scene.triangles.orig_indices.shape[0]) == faces.shape[0] + 2
          and int((scene.lights.shape_kind == 2).sum()) == 1,
          "phase 14: the scene lacks its instances, patches or lights")
    check(len(steps) == iters and len(inst_events) == iters and len(patch_events) == iters,
          f"phase 14: {len(steps)} instanced traces and {len(patch_events)} patch traces "
          f"in {iters} iterations")
    torch.cuda.synchronize()
    inst_ms = np.array([a.elapsed_time(b) for a, b in inst_events])
    patch_ms = np.array([a.elapsed_time(b) for a, b in patch_events])
    timers_s = seen["timers"]
    load = {
        "ply_read": timers_s["ply_read"],
        "object_bvh": timers_s["object_bvh"],
        "top_build": timers_s["instanced_build"] - timers_s["object_bvh"],
        "world_bvh": timers_s["world_bvh"],
        "patch_table": timers_s["patch_table"],
    }
    load["the_rest"] = (seconds - seen["seconds"] - timers_s["ply_read"]
                        - timers_s["instanced_build"] - timers_s["world_bvh"]
                        - timers_s["patch_table"])
    # The object's block of the combined table: the rows from its root (an
    # instance-entry row's col 48) on.  Flattened, each instance would carry
    # a copy of that block and of the object's attribute rows.
    rows = inst.rows8.cpu()
    obj_rows = rows.shape[0] - int(rows[rows[:, 80] == 9][0, 48])
    instanced_bytes = sum(int(t.numel()) * t.element_size()
                          for t in (inst.rows8, inst.attr_rows, inst.inst_inv, inst.inst_fwd))
    flat_bytes = N_INSTANCES * (obj_rows * 128 * 4 + int(inst.attr_rows.numel()) * 4)
    res = {
        "world_triangles": int(scene.triangles.orig_indices.shape[0]),
        "instances": N_INSTANCES,
        "instanced_triangles": N_INSTANCES * n_obj_tris,
        "instanced_rows": int(inst.rows8.shape[0]),
        "object_rows": obj_rows,
        "stack_depth": inst.stack_depth,
        "patches": int(scene.patches.p00.shape[0]),
        "spheres": int(scene.spheres.radius.shape[0]),
        "lights": scene.n_lights,
        "spp": INSTANCED_SPP,
        "load_seconds": load,
        "render_seconds": seen["seconds"],
        "cli_seconds": seconds,
        "rays": stats["rays"],
        "mrays_per_s": stats["rays"] / seen["seconds"] / 1e6,
        "iters": stats["iters"],
        "ms_per_iter": 1e3 * seen["seconds"] / max(iters, 1),
        "kernel_launches": launches,
        "instanced_steps_per_trace": {"min": int(min(steps)), "median": float(np.median(steps)),
                                      "max": int(max(steps))},
        "instanced_ms_per_trace": {"min": float(inst_ms.min()),
                                   "median": float(np.median(inst_ms)),
                                   "max": float(inst_ms.max()), "sum": float(inst_ms.sum())},
        "instanced_ms_per_step": float(inst_ms.sum() / max(sum(steps), 1)),
        "patch_ms_per_trace": {"min": float(patch_ms.min()), "median": float(np.median(patch_ms)),
                               "max": float(patch_ms.max()), "sum": float(patch_ms.sum())},
        "peak_device_bytes": seen["peak_device_bytes"],
        "instanced_table_bytes": instanced_bytes,
        "flattened_rows_and_attrs_bytes": flat_bytes,
        "image_mean": float(img.mean()),
        "card": nvidia_smi_line(),
    }
    log(f"phase 14 instanced scene {BENCH_RESOLUTION[0]}x{BENCH_RESOLUTION[1]} spp "
        f"{INSTANCED_SPP} (cli.main): {json.dumps(res)}")
    out["instanced"] = res

    # (b) the same file small, and (c) the reference's parser scenes: the
    # card against the CPU.
    for name, path in instanced_small_cases(INSTANCED_DIR).items():
        job = load_case(path)
        images, secs = {}, {}
        sc = job.scene.to(dev)
        reset_counts()
        t0 = time.perf_counter()
        img, _, st = small_job_render(job, sc, collect_stats=True)
        images["gpu"] = img.cpu().numpy()
        secs["gpu"] = time.perf_counter() - t0
        card = {"iters": st["iters"], "rays": st["rays"]}
        if sc.has_triangles:
            n = read_counts(f"phase 14 {name}", "v1")
            check(n == int(st["iters"]),
                  f"phase 14 {name}: {n} v1 launches in {st['iters']} iterations")
            card["kernel_launches"] = n
        images["cpu"], secs["cpu"] = cpu_image(f"p14_{name}")
        for dev_name, img in images.items():
            check(np.isfinite(img).all() and img.mean() > 0,
                  f"phase 14: bad {dev_name} {name} image")
        agree = check_agreement(f"phase 14 {name} render", images["gpu"], images["cpu"])
        log(f"phase 14 {name} render {job.film.resolution[0]}x{job.film.resolution[1]} spp "
            f"{job.spp}: seconds {json.dumps(secs)} card {json.dumps(card)} {json.dumps(agree)}")
        out[name] = agree
    return out


# Phase 15: the masked megakernel (render(..., wavefront=False), li_path),
# the other estimators, samplers, filters, cameras, render spaces, color
# spaces and the sensor.
MEGAKERNEL_DIR = Path("chiprun_out") / "phase15"
# (a)'s samples per pixel, cut from the bench's 16 (26.14-33.59 s) to 4,
# held against a wavefront render at 4: at 16 the whole run passed 1,000 s.
MEGAKERNEL_SPP = 4
# The feature scenes of (b), each holding the features its name lists:
# (before Camera, Camera, Sampler, PixelFilter, extra Film parameters).
FEATURE_SCENES = {
    "independent_gaussian_orthographic_screenwindow_cameraspace_rec2020": (
        'ColorSpace "rec2020"\nOption "string rendercoordsys" "camera"',
        'Camera "orthographic" "float screenwindow" [-2.4 2.4 -1.8 1.8]',
        'Sampler "independent"', 'PixelFilter "gaussian"', ""),
    "stratified_mitchell_spherical_equalarea_worldspace_iso_whitebalance": (
        'Option "string rendercoordsys" "world"',
        'Camera "spherical" "string mapping" "equalarea"',
        'Sampler "stratified"', 'PixelFilter "mitchell"',
        '"float iso" [200] "float whitebalance" [5000]'),
    "sinc_spherical_equirect_disablepixeljitter": (
        'Option "bool disablepixeljitter" true',
        'Camera "spherical" "string mapping" "equirect"',
        'Sampler "zsobol"', 'PixelFilter "sinc"', ""),
    "triangle_thinlens_screenwindow_disablewavelengthjitter": (
        'Option "bool disablewavelengthjitter" true',
        'Camera "perspective" "float fov" [45] "float lensradius" [0.08] '
        '"float focaldistance" [3.4] "float screenwindow" [-1.2 1.1 -0.8 0.9]',
        'Sampler "zsobol"', 'PixelFilter "triangle"', ""),
}


def feature_scene_text(case: str) -> str:
    """A small scene (floor, quad light, diffuse, glass and rough gold
    spheres, a sky) under one FEATURE_SCENES case, at SMALL_RES and
    SMALL_SPP."""
    before, camera, sampler, pixel_filter, film = FEATURE_SCENES[case]
    return f"""# Phase 15 feature scene: {case}.
{before}
LookAt 0 0.9 -3.4  0 0.3 0  0 1 0
{camera}
Film "rgb" "integer xresolution" [{SMALL_RES[0]}] "integer yresolution" [{SMALL_RES[1]}] {film}
{sampler} "integer pixelsamples" [{SMALL_SPP}]
{pixel_filter}
Integrator "path" "integer maxdepth" [{MAX_DEPTH}]
WorldBegin
LightSource "infinite" "rgb L" [0.25 0.27 0.3]
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [12 12 12]
  Material "diffuse" "rgb reflectance" [0 0 0]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
      "point3 P" [-0.8 3 -0.8  0.8 3 -0.8  0.8 3 0.8  -0.8 3 0.8]
AttributeEnd
Material "diffuse" "rgb reflectance" [0.5 0.45 0.4]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point3 P" [-6 0 -6  6 0 -6  6 0 6  -6 0 6]
AttributeBegin
  Material "diffuse" "rgb reflectance" [0.7 0.2 0.15]
  Translate -0.9 0.5 0.2
  Shape "sphere" "float radius" [0.5]
AttributeEnd
AttributeBegin
  Material "dielectric" "float eta" [1.5]
  Translate 0.2 0.45 -0.4
  Shape "sphere" "float radius" [0.45]
AttributeEnd
AttributeBegin
  Material "conductor" "spectrum eta" "metal-Au-eta" "spectrum k" "metal-Au-k"
      "float roughness" [0.15]
  Translate 1.1 0.5 0.5
  Shape "sphere" "float radius" [0.5]
AttributeEnd
"""


def megakernel_launches(integrator: str, max_depth: int, interface_media: bool) -> int:
    """v1 launches of one estimator call on a scene with triangles: path
    traces the camera rays, then one merged trace a bounce (and three
    shadow-march rounds with interface media); simplepath a closest-hit
    trace a depth and a shadow trace a bounce; randomwalk a trace a
    depth."""
    if integrator == "path":
        return 1 + max_depth * (4 if interface_media else 1)
    if integrator == "simplepath":
        return 2 * max_depth + 1
    return max_depth + 1


def megakernel_full_render(dev, spp: int) -> tuple[dict, np.ndarray]:
    """(a): the bench scene through render(..., wavefront=False) under v1."""
    scene = build_bench_scene(BENCH_TRIS, BENCH_RESOLUTION, device="cpu")[0].to(dev)
    cam, film = bench_camera_film(BENCH_RESOLUTION)
    n_blocks = -(-BENCH_RESOLUTION[0] * BENCH_RESOLUTION[1] // BLOCK)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    img, _, stats = render(with_config(scene, "v1"), cam, film, ZSobolSampler(spp, BENCH_RESOLUTION),
                           spp=spp, max_depth=MAX_DEPTH, wave_spp=WAVE_SPP, pixel_block=BLOCK,
                           wavefront=False, collect_stats=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts("phase 15 megakernel", "v1")
    want = n_blocks * spp * megakernel_launches("path", MAX_DEPTH, False)
    check(launches == want, f"phase 15: {launches} v1 launches, not n_blocks x spp x "
          f"(1 + max_depth) = {want}")
    img = img.cpu().numpy()
    check(np.isfinite(img).all() and img.mean() > 0, "phase 15: bad megakernel image")
    res = {
        "spp": spp,
        "seconds": seconds,
        "rays": stats["rays"],
        "mrays_per_s": stats["rays"] / seconds / 1e6,
        "kernel_launches": launches,
        "ms_per_bounce": seconds * 1e3 / launches,
        "lane_occupancy": stats["rays"] / (launches * 2 * BLOCK),
        "image_mean": float(img.mean()),
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "card": nvidia_smi_line(),
    }
    return res, img


def megakernel_cases(d: Path) -> dict:
    """(b)'s scene files, written into ``d`` beside the bench sphere's PLY:
    name -> (file, force the megakernel)."""
    d.mkdir(parents=True, exist_ok=True)
    verts, faces = make_displaced_sphere(BENCH_TRIS)
    write_ply(d / LOADED_PLY, verts, faces)
    loaded = loaded_scene_text(SMALL_RES, SMALL_SPP)
    texts = {
        "loaded_megakernel": (loaded, True),
        "loaded_simplepath": (loaded.replace('Integrator "path"', 'Integrator "simplepath"'),
                              False),
        "loaded_randomwalk": (loaded.replace('Integrator "path"', 'Integrator "randomwalk"'),
                              False),
        "interface_media_megakernel": (media_scene_text(SMALL_RES, SMALL_SPP, "interface"), True),
        **{case: (feature_scene_text(case), False) for case in FEATURE_SCENES},
    }
    cases = {}
    for name, (text, megakernel) in texts.items():
        (d / f"{name}.pbrt").write_text(text)
        cases[name] = (d / f"{name}.pbrt", megakernel)
    return cases


def load_case(path: Path):
    builder = SceneBuilder(search_dir=path.parent)
    parse_file(str(path), builder)
    return builder.create(device="cpu", traverse=CONFIGS["v1"])


def render_case(job, scene, megakernel: bool):
    """A (b) case at its in-file settings: the megakernel when forced, else
    the dispatch of its integrator."""
    return render(scene, job.camera, job.film, job.sampler, integrator=job.integrator,
                  spp=job.spp, max_depth=job.max_depth, wave_spp=SMALL_SPP, pixel_block=BLOCK,
                  wavefront=False if megakernel else None, collect_stats=True,
                  disable_pixel_jitter=job.disable_pixel_jitter,
                  disable_wavelength_jitter=job.disable_wavelength_jitter)


def phase15(dev, v1_img: np.ndarray, v1_render: dict) -> dict:
    try:
        return _phase15(dev, v1_img, v1_render)
    finally:
        (MEGAKERNEL_DIR / LOADED_PLY).unlink(missing_ok=True)


def _phase15(dev, v1_img: np.ndarray, v1_render: dict) -> dict:
    out = {"launches": 0}
    # (a) the bench scene through the megakernel, against a wavefront image
    # of the same samples (the same estimator and draws).
    res, img = megakernel_full_render(dev, MEGAKERNEL_SPP)
    out["launches"] += res["kernel_launches"]
    if MEGAKERNEL_SPP == SPP:
        wf_img, wf = v1_img, v1_render
    else:
        wf, wf_img = full_render(build_bench_scene(BENCH_TRIS, BENCH_RESOLUTION, device="cpu")[0]
                                 .to(dev), "v1", "phase 15", MEGAKERNEL_SPP)
        out["launches"] += wf["kernel_launches"]
    res["vs_wavefront"] = check_agreement("phase 15 megakernel vs wavefront", img, wf_img)
    res["wavefront_seconds"] = wf["seconds"]
    res["wavefront_iters"] = wf["iters"]
    res["wavefront_ms_per_iteration"] = wf["seconds"] * 1e3 / wf["iters"]
    res["wavefront_rays"] = wf["rays"]
    res["wavefront_image_mean"] = wf["image_mean"]
    out["wavefront_image"] = wf_img  # phase 18 shards the same samples
    log(f"phase 15 megakernel full render {BENCH_RESOLUTION[0]}x{BENCH_RESOLUTION[1]} spp "
        f"{MEGAKERNEL_SPP}: {json.dumps(res)}")
    out["full"] = res
    torch.cuda.empty_cache()

    # (b) the card against the CPU at 64x48, 4 spp, through the loader.
    for name, (path, megakernel) in megakernel_cases(MEGAKERNEL_DIR).items():
        job = load_case(path)
        on_megakernel = megakernel or job.integrator != "path"
        sc = job.scene.to(dev)
        reset_counts()
        t0 = time.perf_counter()
        img, _, st = render_case(job, sc, megakernel)
        images, secs = {"gpu": img.cpu().numpy()}, {"gpu": time.perf_counter() - t0}
        n = read_counts(f"phase 15 {name}", "v1")
        images["cpu"], secs["cpu"] = cpu_image(f"p15_{name}")
        if on_megakernel:
            want = job.spp * megakernel_launches(job.integrator, job.max_depth,
                                                 sc.has_interface_media)
        else:
            want = int(st["iters"])
        check(n == want, f"phase 15 {name}: {n} v1 launches, expected {want}")
        out["launches"] += n
        for dev_name, im in images.items():
            check(np.isfinite(im).all() and im.mean() > 0,
                  f"phase 15: bad {dev_name} {name} image")
        agree = check_agreement(f"phase 15 {name} render", images["gpu"], images["cpu"])
        log(f"phase 15 {name} render {job.film.resolution[0]}x{job.film.resolution[1]} spp "
            f"{job.spp} ({job.integrator}, {'megakernel' if on_megakernel else 'wavefront'}, "
            f"{type(job.sampler).__name__}, {type(job.film.filter).__name__}, "
            f"{type(job.camera).__name__}): seconds {json.dumps(secs)} card "
            f"{json.dumps({'kernel_launches': n, **st})} {json.dumps(agree)}")
        out[name] = agree
    return out


PHASE16_DIR = Path("chiprun_out") / "phase16"
# (a) a checkpointed wavefront render of the bench scene at a reduced
# resolution, one sample a wave, killed after its second wave.
CHECKPOINT_RES = (320, 180)
CHECKPOINT_SPP = 4
KILL_AFTER = 2
KILLED_EXIT = 17
# (b) many samples a pixel splatted over a Gaussian footprint (16 pixels a
# sample), some hanging over the film's edges.
SPLAT_RES = (128, 72)
SPLAT_SAMPLES = 1 << 20
SPLAT_RTOL, SPLAT_ATOL = 1e-4, 1e-6   # card vs CPU, the atol of the image's largest value
# (c) tests/test_grad.py::TestGradients' scenes at its sizes, seed, steps
# and tolerances; the card's AD against the CPU's within GRAD_RTOL.
GRAD_RES, GRAD_SPP, GRAD_DEPTH, GRAD_SEED = 12, 32, 3, 7
GRAD_RTOL = 1e-3
# (d) the bench scene's backward through li_path(remat="full").
BWD_SPP, BWD_DEPTH = 1, 5


def checkpoint_render(dev, ckpt=None, kill_after=None, on_kill=None):
    """(a)'s render: the bench scene at CHECKPOINT_RES through render(),
    with ``ckpt`` as its checkpoint file; ``kill_after`` ends the process
    (os._exit, no clean-up) once that many waves are done, after calling
    ``on_kill``."""
    scene, cam, film = build_bench_scene(BENCH_TRIS, CHECKPOINT_RES, device="cpu")

    def progress(done, total):
        if done == kill_after:
            on_kill()
            os._exit(KILLED_EXIT)

    return render(with_config(scene.to(dev), "v1"), cam, film,
                  ZSobolSampler(CHECKPOINT_SPP, CHECKPOINT_RES), spp=CHECKPOINT_SPP,
                  max_depth=MAX_DEPTH, wave_spp=1, pixel_block=BLOCK, checkpoint_path=ckpt,
                  progress=progress)


def checkpoint_child(ckpt: str, kill_after, started: float, seconds_file: str):
    """A process of its own for (a): killed after ``kill_after`` waves, or
    (None) resuming from ``ckpt`` to the end.  Writes its seconds since
    ``started`` (the parent's clock when it started the process, start-up
    included) into ``seconds_file`` before it ends."""
    torch.set_num_threads(CPU_THREADS)

    def note():
        Path(seconds_file).write_text(json.dumps(time.time() - started))

    checkpoint_render(torch.device("cuda", 0), ckpt, kill_after, note)
    note()


def splat_inputs(device):
    """(b)'s samples, made from a seed on the host, with their wavelengths
    (sampled on the host: the card's transcendentals round an ulp apart,
    which moved a few samples' colors by up to 4.3% when each device
    sampled its own)."""
    g = torch.Generator().manual_seed(16)
    w, h = SPLAT_RES
    p = torch.rand((SPLAT_SAMPLES, 2), generator=g) * torch.tensor([w + 2.0, h + 2.0]) - 1.0
    lrad = torch.exp(torch.randn((SPLAT_SAMPLES, 4), generator=g))
    swl = splat_film().sample_wavelengths(torch.rand(SPLAT_SAMPLES, generator=g))
    return (p.to(device), lrad.to(device),
            SampledWavelengths(lam=swl.lam.to(device), pdf=swl.pdf.to(device)))


def splat_film():
    cs = get_named_color_space("srgb")
    return RgbFilm(SPLAT_RES, GaussianFilter(1.5, 1.5, 0.6), PixelSensor(cs), cs)


def splat(device) -> torch.Tensor:
    film = splat_film()
    return film.add_splats(film.init_state(device), *splat_inputs(device)).rgb_splat


def _grad_sphere_and_light(albedo, spectrum, scale):
    return dict(
        spheres=[{"radius": 1.0, "material_id": 0},
                 {"radius": 0.3, "material_id": 1, "area_light_id": 0,
                  "object_to_world": Transform.translate([0.0, 2.0, 0.0])}],
        materials=[{"kind": mtl.DIFFUSE, "reflectance": albedo},
                   {"kind": mtl.DIFFUSE, "reflectance": [0.0, 0.0, 0.0]}],
        lights=[{"kind": lt.AREA, "spectrum": ConstantSpectrum(spectrum), "scale": scale,
                 "shape_kind": 0, "shape_idx": 1}])


def _grad_in_env(material):
    cs = get_named_color_space("srgb")
    return dict(
        spheres=[{"radius": 1.0, "material_id": 0}], materials=[material],
        lights=[{"kind": lt.UNIFORM_INFINITE, "spectrum": cs.illuminant, "photometric": True}])


def _grad_textured(device):
    b = tx.TextureBuilder()
    tid = b.add_image(np.full((4, 4, 3), 0.5, np.float32), is_spectrum=True,
                      filter_kind=tx.FILTER_POINT)
    return dict(_grad_in_env({"kind": mtl.DIFFUSE, "reflectance": [0.5, 0.5, 0.5],
                              "tex_reflectance": tid}), textures=b.build(device=device))


# tests/test_grad.py::TestGradients' cases: scene, parameter (table,
# fields, index; the texel row is relative to the level-0 offset; "add"
# shifts instead of setting), finite-difference step and tolerances, and
# its bound on |AD| (None: AD > 0).
GRAD_CASES = {
    "diffuse_reflectance": (lambda d: _grad_sphere_and_light([0.6, 0.5, 0.4], 20.0, 1.0),
                            ("materials", ("reflectance",), (0, 1), False),
                            dict(h=1e-2, rtol=2e-2, atol=0.0), 1e-6),
    "emission_scale": (lambda d: _grad_sphere_and_light([0.7, 0.7, 0.7], 1.0, 20.0),
                       ("lights", ("scale",), (0,), False), dict(h=0.5, rtol=1e-3, atol=0.0),
                       None),
    "conductor_roughness": (
        lambda d: _grad_in_env({"kind": mtl.CONDUCTOR, "uroughness": 0.09, "vroughness": 0.09}),
        ("materials", ("uroughness", "vroughness"), (0,), False),
        dict(h=1e-2, rtol=5e-2, atol=1e-4), 1e-6),
    "texture_texel": (_grad_textured, ("textures", ("atlas",), (5, 2), False),
                      dict(h=5e-3, rtol=5e-2, atol=1e-7), 0.0),
    "texture_whole_atlas": (_grad_textured, ("textures", ("atlas",), (slice(0, 16), 2), True),
                            dict(h=5e-3, rtol=5e-2, atol=0.0), 1e-6),
}


def grad_setup(case: str, device):
    """A case's f(theta) on ``device``: the mean per-lane radiance of
    li_path over every pixel and sample (one call, a lane each), with the
    parameter set to theta; and theta's value in the scene."""
    build, (table, fields, index, add), _, _ = GRAD_CASES[case]
    cs = get_named_color_space("srgb")
    cam = PerspectiveCamera(CameraTransform(Transform.look_at([0.0, 0.0, -4.0], [0.0, 0.0, 0.0],
                                                              [0.0, 1.0, 0.0])),
                            (GRAD_RES, GRAD_RES), fov=45.0)
    film = RgbFilm((GRAD_RES, GRAD_RES), BoxFilter(), PixelSensor(cs), cs)
    scene = build_scene(None, render_from_world=cam.camera_transform.render_from_world(),
                        device=device, **build(device))
    if table == "textures":
        off = int(scene.textures.level0_offset[0])
        row = index[0]
        index = (slice(off + row.start, off + row.stop) if isinstance(row, slice) else off + row,
                 index[1])
    ys, xs = torch.meshgrid(torch.arange(GRAD_RES, dtype=torch.int32),
                            torch.arange(GRAD_RES, dtype=torch.int32), indexing="ij")
    pixels = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)
    # Every pixel's every sample as one lane of one li_path call.
    pixel_xy = pixels.repeat(GRAD_SPP, 1).to(device)
    sample_index = torch.arange(GRAD_SPP).repeat_interleave(pixels.shape[0]).to(device)
    sampler = IndependentSampler(GRAD_SPP, seed=GRAD_SEED)

    def f(theta):
        tab = getattr(scene, table)
        new = {}
        for k in fields:
            base = getattr(tab, k)
            mask = torch.zeros(base.shape, dtype=torch.bool)
            mask[index] = True
            mask = mask.to(device)
            new[k] = (base + torch.where(mask, theta, 0.0) if add
                      else torch.where(mask, theta, base))
        sc = dataclasses.replace(scene, **{table: dataclasses.replace(tab, **new)})
        s_state = sampler.start_pixel_sample(pixel_xy, sample_index)
        u_lam, s_state = sampler.get_1d(s_state)
        swl = film.sample_wavelengths(u_lam)
        u_f, s_state = sampler.get_pixel_2d(s_state)
        u_l, s_state = sampler.get_2d(s_state)
        p_film, _, u_l = get_camera_sample(film.filter, pixel_xy, u_f, u_l)
        ray = cam.generate_ray(p_film, u_l)
        return torch.mean(li_path(sc, ray, swl, sampler, s_state, GRAD_DEPTH))

    base = getattr(getattr(scene, table), fields[0])
    theta0 = 0.0 if add else float(base[index])
    return f, theta0


def grad_ad(case: str, device) -> float:
    f, theta0 = grad_setup(case, device)
    th = torch.tensor(theta0, device=device, requires_grad=True)
    (g,) = torch.autograd.grad(f(th), th)
    return float(g)


def grad_fd(case: str, device) -> float:
    f, theta0 = grad_setup(case, device)
    h = GRAD_CASES[case][2]["h"]
    th = torch.tensor(theta0, device=device)
    with torch.no_grad():
        return float((f(th + h) - f(th - h)) / (2.0 * h))


def bench_backward(dev) -> dict:
    """(d): the bench scene at full width, BWD_SPP spp, depth BWD_DEPTH,
    through render(wavefront=False) with li_path(remat="full"), and the
    gradient of the image mean with respect to the floor's reflectance
    coefficients (material 1)."""
    scene, cam, film = build_bench_scene(BENCH_TRIS, BENCH_RESOLUTION, device="cpu")
    scene = with_config(scene.to(dev), "v1")
    floor = scene.materials.reflectance[1].clone().requires_grad_(True)
    refl = torch.cat([scene.materials.reflectance[:1], floor[None],
                      scene.materials.reflectance[2:]])
    scene = dataclasses.replace(scene, materials=dataclasses.replace(scene.materials,
                                                                     reflectance=refl))
    n_blocks = -(-BENCH_RESOLUTION[0] * BENCH_RESOLUTION[1] // BLOCK)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    img, _ = render(scene, cam, film, ZSobolSampler(BWD_SPP, BENCH_RESOLUTION), spp=BWD_SPP,
                    max_depth=BWD_DEPTH, wave_spp=BWD_SPP, pixel_block=BLOCK, wavefront=False,
                    integrator_options={"remat": "full"})
    loss = img.mean()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fwd_launches = dict(tv.traverse_raw.launches)["v1"]
    fwd_peak = torch.cuda.max_memory_allocated()
    (g,) = torch.autograd.grad(loss, floor)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = read_counts("phase 16 backward", "v1")
    # Per block: the camera trace and one merged trace a bounce forward,
    # each bounce's trace again in its recompute.
    want = n_blocks * BWD_SPP * (1 + 2 * BWD_DEPTH)
    check(fwd_launches == n_blocks * BWD_SPP * (1 + BWD_DEPTH),
          f"phase 16 backward: {fwd_launches} v1 launches in the forward")
    check(launches == want, f"phase 16 backward: {launches} v1 launches, not n_blocks x spp x "
          f"(1 + 2 x depth) = {want}")
    grad = g.cpu().numpy()
    check(np.isfinite(grad).all() and np.abs(grad).sum() > 0,
          f"phase 16 backward: gradient {grad.tolist()}")
    return {
        "resolution": list(BENCH_RESOLUTION), "spp": BWD_SPP, "max_depth": BWD_DEPTH,
        "n_blocks": n_blocks, "image_mean": float(loss.detach()),
        "grad_floor_reflectance": grad.tolist(),
        "forward_seconds": t1 - t0, "backward_seconds": t2 - t1,
        "kernel_launches": launches, "forward_launches": fwd_launches,
        "forward_peak_device_bytes": fwd_peak,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "card": nvidia_smi_line(),
    }


def phase16(dev) -> dict:
    """16. checkpoints, splats and gradients."""
    PHASE16_DIR.mkdir(parents=True, exist_ok=True)
    ckpt = PHASE16_DIR / "bench.ckpt.npz"
    ckpt.unlink(missing_ok=True)
    out = {"launches": 0}
    ctx = multiprocessing.get_context("spawn")
    children = []
    try:
        # (b) splats: twice on the card, the same bits; against the CPU.
        t0 = time.perf_counter()
        first = splat(dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        second = splat(dev)
        torch.cuda.synchronize()
        check(torch.equal(first, second), "phase 16: two card runs of add_splats differ")
        splats = {"samples": SPLAT_SAMPLES, "resolution": list(SPLAT_RES),
                  "samples_per_pixel": SPLAT_SAMPLES / (SPLAT_RES[0] * SPLAT_RES[1]),
                  "card_ms": (t1 - t0) * 1e3, "second_card_ms": (time.perf_counter() - t1) * 1e3,
                  "repeat_equal": True}

        # (a) a process renders with checkpoints and is killed after its
        # second wave; while it starts, this process renders uninterrupted.
        def child(kill_after, tag):
            proc = ctx.Process(target=checkpoint_child,
                               args=(str(ckpt), kill_after, time.time(),
                                     str(PHASE16_DIR / f"{tag}.json")))
            children.append(proc)
            proc.start()
            return proc

        killed = child(KILL_AFTER, "killed")
        reset_counts()
        t0 = time.perf_counter()
        _, whole = checkpoint_render(dev)
        torch.cuda.synchronize()
        res = {"uninterrupted_seconds": time.perf_counter() - t0}
        n = read_counts("phase 16 checkpoint", "v1")
        out["launches"] += n

        cpu, cpu_s = cpu_image("p16_splats")
        card = first.cpu().numpy()
        err = np.abs(card - cpu) - SPLAT_RTOL * np.abs(cpu)
        rel = float((np.abs(card - cpu) / np.maximum(np.abs(cpu), 1e-30)).max())
        check(np.isfinite(card).all() and (err <= SPLAT_ATOL * np.abs(cpu).max()).all(),
              f"phase 16: card splats beyond rtol {SPLAT_RTOL} of the CPU's (max rel {rel})")
        splats.update(cpu_seconds=cpu_s, max_rel_err=rel)
        log(f"phase 16 splats: {json.dumps(splats)}")

        killed.join()
        check(killed.exitcode == KILLED_EXIT, f"phase 16: the killed render ended with "
              f"{killed.exitcode}, not {KILLED_EXIT}")
        with np.load(ckpt) as z:
            check(int(z["spp_done"]) == KILL_AFTER,
                  f"phase 16: the killed render's checkpoint is at {int(z['spp_done'])} spp")
        # The resume in a new process, beside (c).
        resumed = child(None, "resumed")

        # (c) the small gradients: the card's AD against its own central
        # finite difference and against the CPU's AD.
        grads = {}
        for case, (_, _, fd, bound) in GRAD_CASES.items():
            t0 = time.perf_counter()
            ad = grad_ad(case, dev)
            fd_g = grad_fd(case, dev)
            cpu_ad = float(cpu_image(f"p16_grad_{case}")[0][0])
            check(np.isfinite(ad), f"phase 16 {case}: AD {ad}")
            check(abs(ad - fd_g) <= fd["atol"] + fd["rtol"] * abs(fd_g),
                  f"phase 16 {case}: AD {ad} against FD {fd_g}")
            check(abs(ad - cpu_ad) <= GRAD_RTOL * abs(cpu_ad),
                  f"phase 16 {case}: card AD {ad} against CPU AD {cpu_ad}")
            check(ad > 0 if bound is None else abs(ad) > bound, f"phase 16 {case}: AD {ad}")
            grads[case] = {"ad": ad, "fd": fd_g, "cpu_ad": cpu_ad,
                           "seconds": time.perf_counter() - t0}
        log(f"phase 16 gradients {GRAD_RES}x{GRAD_RES} spp {GRAD_SPP} depth {GRAD_DEPTH}: "
            f"{json.dumps(grads)}")

        resumed.join()
        check(resumed.exitcode == 0, f"phase 16: the resumed render ended with {resumed.exitcode}")
        with np.load(ckpt) as z:
            check(int(z["spp_done"]) == CHECKPOINT_SPP, "phase 16: the resume did not finish")
            for name in ("rgb_sum", "weight_sum", "rgb_splat"):
                check(torch.equal(torch.from_numpy(z[name]), getattr(whole, name).cpu()),
                      f"phase 16: the resumed {name} differs from the uninterrupted render's")
        res.update(resolution=list(CHECKPOINT_RES), spp=CHECKPOINT_SPP, killed_after=KILL_AFTER,
                   kernel_launches=n, resumed_equal=True,
                   **{f"{tag}_process_seconds": json.loads((PHASE16_DIR / f"{tag}.json")
                                                           .read_text())
                      for tag in ("killed", "resumed")})
        log(f"phase 16 checkpoint: {json.dumps(res)}")

        # (d) the bench-size backward, alone on the card.
        bwd = bench_backward(dev)
        out["launches"] += bwd["kernel_launches"]
        log(f"phase 16 backward: {json.dumps(bwd)}")
        out.update(checkpoint=res, splats=splats, gradients=grads, backward=bwd)
        return out
    finally:
        for proc in children:
            if proc.is_alive():
                proc.terminate()
                proc.join()
        ckpt.unlink(missing_ok=True)


# 17. The replay wavefront: (a) tests/test_grad.py::
# TestReplayWavefrontGradients' scene at its sizes; (b) the bench backward
# of phase 16 (d) through the replay.
REPLAY_RES, REPLAY_SPP, REPLAY_DEPTH = 12, 2, 3
REPLAY_VALUE_RTOL = 1e-5  # replay value against the wavefront's
REPLAY_GRAD_RTOL = 1e-4   # replay gradient against the megakernel's (atomic adds)
# 18. Sharding: the bench in tiles and spp mode over two bands of one card
# (the samples of phase 15's wavefront image), a world-1 NCCL child, and
# the sharded training step card against CPU.
SHARD_BANDS = 2
SHARD_SPP = MEGAKERNEL_SPP
SHARD_TILES_RTOL = 1e-6
SHARD_SPP_RTOL = 1e-5
FLAGSHIP_RES, FLAGSHIP_SPP, FLAGSHIP_DEPTH = (16, 16), 2, 2
PHASE18_DIR = Path("chiprun_out") / "phase18"


def replay_values(device) -> dict:
    """(a): the value and the gradient with respect to reflectance
    coefficient (0, 1) of the mean film sum, through the replay wavefront,
    the megakernel and (value only) the wavefront."""
    cs = get_named_color_space("srgb")
    cam = PerspectiveCamera(CameraTransform(Transform.look_at([0.0, 0.0, -4.0], [0.0, 0.0, 0.0],
                                                              [0.0, 1.0, 0.0])),
                            (REPLAY_RES, REPLAY_RES), fov=45.0)
    film = RgbFilm((REPLAY_RES, REPLAY_RES), BoxFilter(), PixelSensor(cs), cs)
    scene = build_scene(None, render_from_world=cam.camera_transform.render_from_world(),
                        device=device, **_grad_sphere_and_light([0.6, 0.5, 0.4], 20.0, 1.0))
    sampler = IndependentSampler(REPLAY_SPP)
    pixel_xy = render_module.full_image_pixels(film, device)
    valid = torch.ones(pixel_xy.shape[0], dtype=torch.bool, device=device)
    idx = torch.arange(REPLAY_SPP, device=device)
    mask = torch.zeros(scene.materials.reflectance.shape, dtype=torch.bool)
    mask[0, 1] = True
    mask = mask.to(device)
    theta0 = float(scene.materials.reflectance[0, 1])

    def with_theta(theta):
        refl = torch.where(mask, theta, scene.materials.reflectance)
        return dataclasses.replace(scene, materials=dataclasses.replace(scene.materials,
                                                                        reflectance=refl))

    def value_grad(render_fn):
        th = torch.tensor(theta0, device=device, requires_grad=True)
        v = render_fn(with_theta(th)).rgb_sum.sum() / pixel_xy.shape[0]
        (g,) = torch.autograd.grad(v, th)
        return float(v.detach()), float(g)

    replay = render_module.make_replay_wavefront_renderer(scene, cam, film, sampler,
                                                          max_depth=REPLAY_DEPTH)
    out = {}
    out["replay_value"], out["replay_grad"] = value_grad(
        lambda sc: replay(sc, film.init_state(device), idx, pixel_xy, valid))
    out["megakernel_value"], out["megakernel_grad"] = value_grad(
        lambda sc: render_module.render_pixel_samples(
            sc, cam, film, sampler, li_path, {}, film.init_state(device), idx, pixel_xy,
            pixel_valid=valid, max_depth=REPLAY_DEPTH)[0])
    fs, _ = make_wavefront_renderer(scene, cam, film, sampler, max_depth=REPLAY_DEPTH)(
        film.init_state(device), idx, pixel_xy, valid)
    out["wavefront_value"] = float(fs.rgb_sum.sum() / pixel_xy.shape[0])
    return out


def replay_bench(dev, megakernel_grad: list) -> dict:
    """(b): phase 16 (d)'s bench backward (1280x720, BWD_SPP spp, depth
    BWD_DEPTH, the floor's reflectance) through the replay wavefront over
    every pixel block: the wavefront forward, then each block's paths
    replayed by the megakernel in the backward."""
    scene, cam, film = build_bench_scene(BENCH_TRIS, BENCH_RESOLUTION, device="cpu")
    scene = with_config(scene.to(dev), "v1")
    floor = scene.materials.reflectance[1].clone().requires_grad_(True)
    refl = torch.cat([scene.materials.reflectance[:1], floor[None],
                      scene.materials.reflectance[2:]])
    scene = dataclasses.replace(scene, materials=dataclasses.replace(scene.materials,
                                                                     reflectance=refl))
    sampler = ZSobolSampler(BWD_SPP, BENCH_RESOLUTION)
    wave = render_module.make_replay_wavefront_renderer(scene, cam, film, sampler,
                                                        max_depth=BWD_DEPTH, with_stats=True)
    blocks, valids = pixel_blocks(film, BLOCK, dev)
    n_blocks = blocks.shape[0]
    idx = torch.arange(BWD_SPP, device=dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    state, iters = film.init_state(dev), 0.0
    for b in range(n_blocks):
        state, st = wave(scene, state, idx, blocks[b], valids[b])
        iters += float(st["iters"])
    loss = film.get_image(state).mean()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fwd_launches = dict(tv.traverse_raw.launches)["v1"]
    fwd_peak = torch.cuda.max_memory_allocated()
    (g,) = torch.autograd.grad(loss, floor)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = read_counts("phase 17 backward", "v1")
    replay_launches = n_blocks * BWD_SPP * (1 + BWD_DEPTH)
    check(fwd_launches == int(iters),
          f"phase 17 backward: {fwd_launches} v1 launches in the forward, {iters} iterations")
    check(launches == int(iters) + replay_launches,
          f"phase 17 backward: {launches} v1 launches, not the wavefront's {int(iters)} "
          f"iterations + n_blocks x spp x (1 + depth) = {replay_launches}")
    grad = g.cpu().numpy()
    want = np.asarray(megakernel_grad)
    rel = float(np.max(np.abs(grad - want) / np.abs(want)))
    check(np.isfinite(grad).all() and rel <= REPLAY_GRAD_RTOL,
          f"phase 17 backward: gradient {grad.tolist()} against phase 16's {want.tolist()}")
    return {
        "resolution": list(BENCH_RESOLUTION), "spp": BWD_SPP, "max_depth": BWD_DEPTH,
        "n_blocks": n_blocks, "image_mean": float(loss.detach()),
        "grad_floor_reflectance": grad.tolist(), "megakernel_grad": want.tolist(),
        "grad_max_rel_err": rel, "forward_seconds": t1 - t0, "backward_seconds": t2 - t1,
        "wavefront_iters": int(iters), "forward_launches": fwd_launches,
        "replay_launches": launches - fwd_launches, "kernel_launches": launches,
        "forward_peak_device_bytes": fwd_peak,
        "peak_device_bytes": torch.cuda.max_memory_allocated(), "card": nvidia_smi_line(),
    }


def phase17(dev, megakernel_grad: list) -> dict:
    """17. the replay wavefront's gradients."""
    t0 = time.perf_counter()
    card = replay_values(dev)
    card["seconds"] = time.perf_counter() - t0
    cpu, cpu_s = cpu_image("p17_replay")
    check(abs(card["replay_value"] - card["wavefront_value"])
          <= REPLAY_VALUE_RTOL * abs(card["wavefront_value"]),
          f"phase 17: replay value {card['replay_value']} against the wavefront's "
          f"{card['wavefront_value']}")
    check(card["replay_grad"] != 0.0 and abs(card["replay_grad"] - card["megakernel_grad"])
          <= REPLAY_GRAD_RTOL * abs(card["megakernel_grad"]),
          f"phase 17: replay gradient {card['replay_grad']} against the megakernel's "
          f"{card['megakernel_grad']}")
    for i, key in enumerate(("replay_value", "replay_grad")):
        check(abs(card[key] - cpu[i]) <= GRAD_RTOL * abs(cpu[i]),
              f"phase 17: card {key} {card[key]} against the CPU's {cpu[i]}")
    card.update(cpu_replay_value=float(cpu[0]), cpu_replay_grad=float(cpu[1]), cpu_seconds=cpu_s)
    log(f"phase 17 replay {REPLAY_RES}x{REPLAY_RES} spp {REPLAY_SPP} depth {REPLAY_DEPTH}: "
        f"{json.dumps(card)}")
    torch.cuda.empty_cache()
    bench = replay_bench(dev, megakernel_grad)
    log(f"phase 17 replay backward: {json.dumps(bench)}")
    return {"launches": bench["kernel_launches"], "small": card, "backward": bench}


def max_rel(a: np.ndarray, b: np.ndarray) -> float:
    """max |a - b| / |b|, with |b| floored at 1e-6 of max |b|."""
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-6 * np.abs(b).max())))


def flagship_render(mesh):
    """The flagship at FLAGSHIP_RES, rendered in tiles mode over ``mesh``
    (the numbers of experiments/dryrun_multihost.py)."""
    scene, cam, film = flagship(FLAGSHIP_RES, mesh.devices[0])
    return render_sharded(scene, cam, film, IndependentSampler(FLAGSHIP_SPP, seed=3), mesh,
                          spp=FLAGSHIP_SPP, max_depth=FLAGSHIP_DEPTH, wave_spp=FLAGSHIP_SPP)[0]


def nccl_child(port: int, out_dir: str, started: float, device: str):
    """(c): a process of its own joins a world of one (NCCL on a card),
    renders the flagship through render_multihost and runs
    dryrun_multichip."""
    torch.set_num_threads(CPU_THREADS)
    out = Path(out_dir)
    initialize_distributed(f"localhost:{port}", 1, 0, device=device)
    try:
        backend = torch.distributed.get_backend()
        scene, cam, film = flagship(FLAGSHIP_RES, device)
        img = render_multihost(scene, cam, film, IndependentSampler(FLAGSHIP_SPP, seed=3),
                               spp=FLAGSHIP_SPP, max_depth=FLAGSHIP_DEPTH,
                               wave_spp=FLAGSHIP_SPP)
        np.save(out / "multihost.npy", img.cpu().numpy())
        dry = dryrun_multichip([device])
        (out / "child.json").write_text(json.dumps({
            "backend": backend, "world_size": torch.distributed.get_world_size(),
            "loss": dry["loss"], "grad": dry["grad"].tolist(),
            "step_seconds": dry["step_seconds"], "wave_image_mean": dry["wave_image_mean"],
            "process_seconds": time.time() - started}))
    finally:
        torch.distributed.destroy_process_group()


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def shard_bench(dev, wf_img: np.ndarray, mode: str) -> dict:
    """(a) / (b): the bench at full width over SHARD_BANDS bands of the
    card, against phase 15's unsharded wavefront image of the same
    samples; v1 launches exactly the bands' iterations."""
    scene, cam, film = build_bench_scene(BENCH_TRIS, BENCH_RESOLUTION, device="cpu")
    scene = with_config(scene.to(dev), "v1")
    mesh = make_tile_mesh([dev] * SHARD_BANDS)
    # tiles: one wave of every sample; spp: two waves, a sample a band each.
    wave_spp = SHARD_SPP if mode == "tiles" else SHARD_SPP // (2 * SHARD_BANDS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    img, _, st = render_sharded(scene, cam, film, ZSobolSampler(SHARD_SPP, BENCH_RESOLUTION),
                                mesh, spp=SHARD_SPP, max_depth=MAX_DEPTH, wave_spp=wave_spp,
                                mode=mode, collect_stats=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts(f"phase 18 {mode}", "v1")
    check(launches == int(st["iters"]),
          f"phase 18 {mode}: {launches} v1 launches, the bands' iterations {st['iters']}")
    img = img.cpu().numpy()
    rel = max_rel(img, wf_img)
    tol = SHARD_TILES_RTOL if mode == "tiles" else SHARD_SPP_RTOL
    check(np.isfinite(img).all() and rel <= tol,
          f"phase 18 {mode}: max relative {rel} from the unsharded image, over {tol}")
    return {"mode": mode, "bands": SHARD_BANDS, "spp": SHARD_SPP, "wave_spp": wave_spp,
            "seconds": seconds, "kernel_launches": launches, "iters": st["iters"],
            "rays": st["rays"], "max_rel_err": rel, "equal": bool(np.array_equal(img, wf_img)),
            "image_mean": float(img.mean()), "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "card": nvidia_smi_line()}


def phase18(dev, wf_img: np.ndarray) -> dict:
    """18. sharding: tiles and spp mode, the NCCL world-1 child, the
    sharded training step."""
    PHASE18_DIR.mkdir(parents=True, exist_ok=True)
    for name in ("multihost.npy", "child.json"):
        (PHASE18_DIR / name).unlink(missing_ok=True)
    out = {"launches": 0}
    ctx = multiprocessing.get_context("spawn")
    # (c) first, in a process of its own, beside (a) and (b).
    child = ctx.Process(target=nccl_child,
                        args=(free_port(), str(PHASE18_DIR), time.time(), str(dev)))
    child.start()
    try:
        for mode in ("tiles", "spp"):
            res = shard_bench(dev, wf_img, mode)
            out["launches"] += res["kernel_launches"]
            out[mode] = res
            log(f"phase 18 {mode} {BENCH_RESOLUTION[0]}x{BENCH_RESOLUTION[1]}: {json.dumps(res)}")
            torch.cuda.empty_cache()

        # (d) the sharded training step on two bands, card against CPU.
        reset_counts()
        t0 = time.perf_counter()
        dry = dryrun_multichip([dev] * SHARD_BANDS)
        seconds = time.perf_counter() - t0
        n = read_counts("phase 18 dryrun", "v1")
        out["launches"] += n
        cpu_grad, cpu_s = cpu_image("p18_dryrun_grad")
        card_grad = dry["grad"].reshape(-1)
        rel = float(np.max(np.abs(card_grad - cpu_grad) / np.abs(cpu_grad).max()))
        check(rel <= GRAD_RTOL, f"phase 18 dryrun: card gradient {card_grad.tolist()} against "
              f"the CPU's {cpu_grad.tolist()}")
        dryrun = {"bands": dry["bands"], "resolution": dry["resolution"], "loss": dry["loss"],
                  "grad": card_grad.tolist(), "cpu_grad": cpu_grad.tolist(),
                  "max_rel_err_of_max": rel, "step_seconds": dry["step_seconds"],
                  "seconds": seconds, "cpu_seconds": cpu_s, "kernel_launches": n}
        log(f"phase 18 dryrun_multichip: {json.dumps(dryrun)}")

        # (c) the child's image against this process's render of the same
        # bands.
        reset_counts()
        mine = flagship_render(make_tile_mesh([dev])).cpu().numpy()
        out["launches"] += read_counts("phase 18 flagship", "v1")
        child.join(timeout=CPU_WAIT_S)
        check(child.exitcode == 0, f"phase 18: the NCCL child ended with {child.exitcode}")
        theirs = np.load(PHASE18_DIR / "multihost.npy")
        info = json.loads((PHASE18_DIR / "child.json").read_text())
        rel = max_rel(theirs, mine)
        check(info["backend"] == ("nccl" if dev.type == "cuda" else "gloo")
              and info["world_size"] == 1,
              f"phase 18: the child ran {info['backend']} over {info['world_size']}")
        check(rel <= SHARD_TILES_RTOL, f"phase 18: render_multihost's image {rel} from this "
              f"process's")
        info.update(max_rel_err=rel, equal=bool(np.array_equal(theirs, mine)),
                    image_mean=float(theirs.mean()))
        log(f"phase 18 NCCL world 1 child: {json.dumps(info)}")
        out.update(dryrun=dryrun, nccl=info)
        return out
    finally:
        if child.is_alive():
            child.terminate()
            child.join()


# The CPU halves of the card-against-CPU checks (phases 4 and 10-18) are
# rendered in processes of their own, which main() starts after the build,
# beside the card's phases: each image lands as <CPU_DIR>/<case>.npy with
# its render seconds in <case>.json, and the card's half waits for it.
CPU_DIR = Path("chiprun_out") / "cpu_half"
# The phases each process renders, in the order main() reaches them, and
# the threads each process takes of the host's cores.
CPU_HALVES = ((4, 10, 11, 12, 14), (13, 15, 16, 17, 18))
CPU_THREADS = 2
CPU_WAIT_S = 900
_cpu_workers: list = []


def cpu_cases(phase: int, d: Path):
    """(case, render) pairs of ``phase``'s CPU half, each scene built
    before its pair is yielded; scene files go into ``d``, which holds the
    bench sphere's PLY."""
    if phase in (4, 10):
        build = build_bench_scene if phase == 4 else build_material_bench_scene
        scene = build(BENCH_TRIS, BENCH_RESOLUTION, device="cpu")[0]
        names = dict.fromkeys(map(phase4_cpu_config, CONFIGS)) if phase == 4 else ("v1",)
        for name in names:
            case = f"p4_{name}" if phase == 4 else "p10"
            yield case, lambda name=name: small_bench_render(scene, name)
        return
    if phase == 17:
        yield "p17_replay", lambda: np.array([replay_values("cpu")[k]
                                              for k in ("replay_value", "replay_grad")])
        return
    if phase == 18:
        yield "p18_dryrun_grad", lambda: dryrun_multichip(["cpu"] * SHARD_BANDS)["grad"].reshape(-1)
        return
    if phase == 16:
        yield "p16_splats", lambda: splat("cpu").numpy()
        for case in GRAD_CASES:
            yield f"p16_grad_{case}", lambda case=case: np.array([grad_ad(case, "cpu")])
        return
    if phase == 15:
        for name, (path, megakernel) in megakernel_cases(d).items():
            job = load_case(path)
            yield (f"p15_{name}",
                   lambda job=job, mk=megakernel: render_case(job, job.scene, mk)[0].numpy())
        return
    if phase == 11:
        files = {"p11": (d / "loaded_small.pbrt", loaded_scene_text(SMALL_RES, SMALL_SPP))}
    elif phase == 12:
        write_texture_files(d)
        files = {"p12": (d / "textured_small.pbrt", textured_scene_text(SMALL_RES, SMALL_SPP))}
    elif phase == 13:
        files = {f"p13_{v}": (d / f"{v}_small.pbrt", media_scene_text(SMALL_RES, SMALL_SPP, v))
                 for v in MEDIA_VARIANTS}
    else:
        files = {f"p14_{name}": (path, None) for name, path in instanced_small_cases(d).items()}
    for case, (path, text) in files.items():
        if text is not None:
            path.write_text(text)
        job = load_case(path)
        yield case, lambda job=job: small_job_render(job, job.scene)[0].numpy()


def cpu_half(phases: tuple, out_dir: str):
    """One CPU-half process: renders its phases' cases in order, each
    image written whole before its name appears."""
    torch.set_num_threads(CPU_THREADS)
    out = Path(out_dir)
    d = out / ("scenes_" + "_".join(map(str, phases)))
    d.mkdir(parents=True, exist_ok=True)
    try:
        verts, faces = make_displaced_sphere(BENCH_TRIS)
        write_ply(d / LOADED_PLY, verts, faces)
        for phase in phases:
            for case, fn in cpu_cases(phase, d):
                t0 = time.perf_counter()
                img = fn()
                (out / f"{case}.json").write_text(
                    json.dumps({"seconds": time.perf_counter() - t0}))
                np.save(out / f"{case}.tmp.npy", img)
                os.replace(out / f"{case}.tmp.npy", out / f"{case}.npy")
    finally:
        shutil.rmtree(d, ignore_errors=True)


def start_cpu_halves():
    shutil.rmtree(CPU_DIR, ignore_errors=True)
    CPU_DIR.mkdir(parents=True)
    ctx = multiprocessing.get_context("spawn")
    for phases in CPU_HALVES:
        # A daemon: it ends with this process, whatever happens to it.
        worker = ctx.Process(target=cpu_half, args=(phases, str(CPU_DIR)), daemon=True)
        worker.start()
        _cpu_workers.append(worker)


def cpu_image(case: str) -> tuple[np.ndarray, float]:
    """The CPU half's image of ``case`` and its render seconds, once the
    process that renders it has written them."""
    path = CPU_DIR / f"{case}.npy"
    t0 = time.monotonic()
    while not path.exists():
        codes = [w.exitcode for w in _cpu_workers]
        check(all(c in (None, 0) for c in codes), f"{case}: a CPU-half process ended with {codes}")
        check(None in codes or path.exists(), f"{case}: the CPU halves ended without it")
        check(time.monotonic() - t0 < CPU_WAIT_S, f"{case}: no CPU image after {CPU_WAIT_S} s")
        time.sleep(0.1)
    waited = time.monotonic() - t0
    if waited > 0.5:
        log(f"waited {waited:.1f}s for the CPU half's {case}")
    return np.load(path), json.loads((CPU_DIR / f"{case}.json").read_text())["seconds"]


def stop_cpu_halves():
    for worker in _cpu_workers:
        worker.join(timeout=60)
        check(worker.exitcode == 0, f"a CPU-half process ended with {worker.exitcode}")


def kernel_rows(batches: dict, renders: dict, large: dict, gathers: dict,
                packets: dict, later_launches: int) -> list[dict]:
    rows = []
    for row, (cfg, source, replaces) in KERNEL_ROWS.items():
        if row.endswith("large_table"):
            merged = large["compare"][cfg]
            launches = large["render"][cfg]["kernel_launches"]
            err = merged["max_abs_err_t"]
        else:
            merged = batches[cfg][-1]
            launches = renders[cfg]["kernel_launches"]
            if cfg == "v1":
                launches += later_launches  # the card renders of phases 15-18
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
    wall = PhaseWall()
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
    # The CPU halves of phases 4 and 10-16, beside the card's phases.
    start_cpu_halves()
    wall.mark(2)

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
    wall.mark(3)
    # 4. small render, card against CPU, under every configuration
    del scene_cpu
    phase4(scene_gpu)
    wall.mark(4)
    # 5. the full bench render through the port's entry point (v1)
    renders = {}
    renders["v1"], v1_img = phase5(scene_gpu)
    wall.mark(5)
    # 6. the full bench render under the other configurations
    renders.update(phase6(scene_gpu, v1_img))
    wall.mark(6)
    del scene_gpu, tris
    torch.cuda.empty_cache()
    # 7. the 1.3M-triangle leg
    large = phase7(dev)
    wall.mark(7)
    torch.cuda.empty_cache()
    # 8. the row-gather kernels through their micro-benchmark entry point
    gathers = phase8(dev)
    wall.mark(8)
    # 9. the packet-step kernels through theirs
    packets = phase9(dev, bench_tables)
    wall.mark(9)
    del bench_tables
    torch.cuda.empty_cache()
    # 10. the material bench scene through the port's entry point (v1)
    phase10(dev)
    wall.mark(10)
    torch.cuda.empty_cache()
    # 11. scene files through the loader: the goldens, a loaded bench scene
    phase11(dev)
    wall.mark(11)
    torch.cuda.empty_cache()
    # 12. textures and the image environment light through the loader
    phase12(dev)
    wall.mark(12)
    torch.cuda.empty_cache()
    # 13. delta lights and media through the loader
    phase13(dev)
    wall.mark(13)
    torch.cuda.empty_cache()
    # 14. bilinear patches and instancing through the loader
    phase14(dev)
    wall.mark(14)
    torch.cuda.empty_cache()
    # 15. the megakernel and the other estimators, samplers, filters and
    # cameras
    mk = phase15(dev, v1_img, renders["v1"])
    wall.mark(15)
    torch.cuda.empty_cache()
    # 16. checkpoints, splats and gradients
    p16 = phase16(dev)
    wall.mark(16)
    torch.cuda.empty_cache()
    # 17. the replay wavefront's gradients
    p17 = phase17(dev, p16["backward"]["grad_floor_reflectance"])
    wall.mark(17)
    torch.cuda.empty_cache()
    # 18. sharding: row bands, spp, a world-1 NCCL process, the training step
    p18 = phase18(dev, mk["wavefront_image"])
    wall.mark(18)
    stop_cpu_halves()

    later = mk["launches"] + p16["launches"] + p17["launches"] + p18["launches"]
    print(json.dumps({"kernels": kernel_rows(batches, renders, large, gathers, packets, later)}),
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
