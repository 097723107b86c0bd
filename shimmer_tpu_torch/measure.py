"""Measurement helpers of experiments/kernel_ab.py and the card tests: the
bench traversal batches, the ray layouts the kernel is timed on, a
CUDA-event timer, visit statistics, the bound of a traversal launch, a
patterned stack for the step attribution (row 15) and a reader of nvcc's
``-Xptxas -v`` log.

It imports nothing of shimmer_tpu_torch when it is imported, only inside
its functions: kernel_ab.py loads this file from its own checkout while
the package on ``PYTHONPATH`` may be an older checkout under test, and
every call then measures that checkout.
"""

from __future__ import annotations

import re
import subprocess

import numpy as np
import torch

BLOCK = 1 << 17
SPP = 16

# The least time of a traversal launch: the larger of bytes over the HBM
# rate and float32 operations over the non-tensor-core float32 peak
# (NVIDIA H100 SXM data sheet rates).  Bytes: each input read once and
# each output written once, counting only the table entries these rays
# read (the launch's own `touched` record): per internal row visited its 6
# box-coordinate and 1 valid-flag groups of 8 floats, per leaf row visited
# its 9 vertex-coordinate groups (the id group, read only on a hit, is
# left out), per meta word read 4 bytes, per child-leaf word read 4 bytes
# (v2 reads one per internal row it visits); plus the rays.  Operations: 208
# per node visit (the slab test of 8 child boxes, 26 each; a leaf visit
# of 8 triangles costs more, so this is a lower bound), times the visits
# of the launch being bounded.  Rows and visits are those of the kernel
# that made the launch: a traversal order that visits less lowers its own
# bound.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
OPS_PER_VISIT = 8 * 26
INTERNAL_ROW_BYTES = 7 * 8 * 4
LEAF_ROW_BYTES = 9 * 8 * 4
RAY_BYTES_IN = 12 + 12 + 4 + 1    # o, d, t_max, any-hit flag
RAY_BYTES_OUT = 4 + 4             # t, tri


def primary_rays(cam, film, sampler, pixel_xy):
    from shimmer_tpu_torch.film.filters import get_camera_sample

    s = sampler.start_pixel_sample(pixel_xy, 0)
    _, s = sampler.get_1d(s)
    u_f, s = sampler.get_pixel_2d(s)
    u_l, s = sampler.get_2d(s)
    p_film, _, u_l = get_camera_sample(film.filter, pixel_xy, u_f, u_l)
    ray = cam.generate_ray(p_film, u_l)
    return ray.o.contiguous(), ray.d.contiguous(), s


def bench_batches(scene, cam, film, dev) -> dict:
    """The three traversal batches of the first pixel block: primary,
    bounce and the merged wavefront launch, as (o, d, t_max, any_hit).
    The primary hits that seed the bounce rays come from the plain
    traversal, so the batches do not depend on the kernel under test."""
    from shimmer_tpu_torch.ops import traverse as tv
    from shimmer_tpu_torch.ops.ray import offset_ray_origin
    from shimmer_tpu_torch.ops.sampling import sample_cosine_hemisphere
    from shimmer_tpu_torch.render import pixel_blocks
    from shimmer_tpu_torch.samplers import ZSobolSampler
    from shimmer_tpu_torch.shapes.triangle import triangle_interaction_from_raw

    tris = scene.triangles.with_traverse(tv.TraverseConfig("v1", "watertight", "slot"))
    sampler = ZSobolSampler(SPP, film.resolution)
    blocks, _ = pixel_blocks(film, BLOCK, dev)
    inf = torch.full((BLOCK,), float("inf"), device=dev)
    o, d, s_state = primary_rays(cam, film, sampler, blocks[0])

    # Bounce rays: cosine-hemisphere directions around the shading normal
    # of the primary hits (missed lanes borrow a hit lane's point).
    never = torch.zeros(BLOCK, dtype=torch.bool, device=dev)
    _, tri = tv.traverse_raw_plain(tris.rows8, tris.stack_depth, o, d, inf, never)
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
        "primary": (o, d, inf, never),
        "bounce": (bo, bd, inf, never),
        "merged": merged,
    }


def layouts(tris, o, d, t_max, want) -> dict:
    """The kernel's inputs sorted as traverse_raw lays them out, and
    unsorted."""
    from shimmer_tpu_torch.ops import traverse as tv

    order = tv.ray_order(tris, o, d, t_max, want)
    table = (tris.rows8, tris.meta, tris.stack_depth)
    return {
        "sorted": (*table, o[order].contiguous(), d[order].contiguous(),
                   t_max[order].contiguous(), want[order].contiguous()),
        "unsorted": (*table, o, d, t_max, want.contiguous()),
    }


def cuda_ms(fn, reps: int = 20) -> float:
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


def simd_efficiency(steps) -> float:
    """Sum of steps over 32 x the sum of each warp's largest step count,
    warps taken as 32 consecutive rays of the launch."""
    s = steps.double()
    pad = (-s.numel()) % 32
    w = torch.cat([s, s.new_zeros(pad)]).view(-1, 32)
    return float(s.sum() / (32.0 * w.max(dim=1).values.sum()))


def step_stats(steps, live) -> dict:
    """Visits per live ray and SIMD efficiency of one launch's steps (in
    the order the launch took the rays)."""
    s = steps[live].double()
    q = torch.quantile(s, torch.tensor([0.5, 0.99], dtype=torch.float64, device=s.device))
    return {"steps_mean": float(s.mean()), "steps_p50": float(q[0]),
            "steps_p99": float(q[1]), "steps_max": int(s.max()),
            "simd_efficiency": simd_efficiency(steps)}


def traversal_bound(tris, touched, n_rays: int, visits: int, child_leaf: bool = False) -> dict:
    """The bound of one traversal launch (see HBM_BYTES_PER_S) from the
    launch's ``touched`` record and its visits: bound_ms, bound_by and the
    work counted.  ``child_leaf``: the launch read the child-leaf word of
    each internal row it visited."""
    n_rows = tris.meta.shape[0]
    rows = touched[:n_rows].bool()
    leaf = (tris.meta & 15) > 0
    work = {
        "visits": visits,
        "internal_rows_read": int((rows & ~leaf).sum()),
        "leaf_rows_read": int((rows & leaf).sum()),
        "meta_words_read": int(touched[n_rows:].sum()),
    }
    work["child_leaf_words_read"] = work["internal_rows_read"] if child_leaf else 0
    work["bytes"] = (work["internal_rows_read"] * INTERNAL_ROW_BYTES
                     + work["leaf_rows_read"] * LEAF_ROW_BYTES
                     + (work["meta_words_read"] + work["child_leaf_words_read"]) * 4
                     + n_rays * (RAY_BYTES_IN + RAY_BYTES_OUT))
    t_bytes = work["bytes"] / HBM_BYTES_PER_S
    t_ops = visits * OPS_PER_VISIT / FP32_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", **work}


def launch_kwargs(tris) -> dict:
    """The table arguments a launch takes beside a layout: the child-leaf
    words v2 reads, where the checkout's tables carry them (before the v2
    redesign they did not, and its launch takes none)."""
    child_leaf = getattr(tris, "child_leaf", None)
    return {} if child_leaf is None else {"child_leaf": child_leaf}


def launch_bound(tris, args, cfg) -> tuple[dict, dict]:
    """One kernel launch of ``cfg`` on ``args`` (a layout) with its steps
    and ``touched`` record: (its bound, its visit statistics)."""
    from shimmer_tpu_torch.ops import traverse as tv

    touched = torch.zeros(2 * tris.meta.shape[0], dtype=torch.uint8, device=args[3].device)
    kw = launch_kwargs(tris)
    _, _, steps = tv._launch_kernel(*args, True, cfg, touched=touched, **kw)
    return (traversal_bound(tris, touched, args[3].shape[0], int(steps.sum()),
                            child_leaf=cfg.kernel == "v2" and bool(kw)),
            step_stats(steps, args[5] > 0))


def patterned_stack(n_rows: int, packets: int, size: int, seed: int):
    """(packets, size) int32 stacks for row 15 whose chain walks the table,
    in place of interpret mode's INT32_MIN: each slot's high part (the
    popped row, less the step's offset of at most 7 + steps) a row below R
    - 300 (or 0 on a smaller table), its low byte random bits."""
    rng = np.random.default_rng(seed)
    high = rng.integers(0, max(n_rows - 300, 1), (packets, size))
    return torch.from_numpy((high * 256 + rng.integers(0, 256, (packets, size))).astype(np.int32))


def demangle(names: list[str]) -> list[str]:
    """C++ names as c++filt prints them, where it is installed."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, timeout=60, check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return names
    return out if len(out) == len(names) else names


def ptxas_report(build_log: str) -> list[dict]:
    """Per kernel of an nvcc ``-Xptxas -v`` log: registers, stack frame,
    spill stores and loads, and static shared memory in bytes."""
    kernels, cur = [], None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"kernel": m.group(1)}
            kernels.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur.update(stack_frame=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(sm.group(1)) if sm else 0
    for k, name in zip(kernels, demangle([k["kernel"] for k in kernels])):
        name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
        k["kernel"] = name.split("(")[0]
    return kernels
