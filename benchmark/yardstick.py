"""The traversal yardstick: a frozen merged batch of wavefront rays, the
port's traversal timed on it with CUDA events, and the least time the
card could take for it, counted from the work of the frozen plain
traversal (``benchmark.reference.frozen.ops.traverse``) on the
reference's own BVH8.  The bound therefore stays the same whichever
kernel, layout or BVH the port uses.

Bound: the larger of bytes over the HBM rate and float32 operations
over the float32 peak outside the tensor cores (NVIDIA H100 SXM data
sheet, 700 W).  Bytes: each row the plain traversal visits read once (an
internal row's 6 box-coordinate and 1 valid-flag groups of 8 floats; a
leaf row's 9 vertex-coordinate groups), plus each ray's inputs and
outputs once.  Operations: 208 per node visit (the slab test of 8 child
boxes, 26 each; a leaf visit costs more, so this is a lower bound).
"""

from __future__ import annotations

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
OPS_PER_VISIT = 8 * 26
INTERNAL_ROW_BYTES = 7 * 8 * 4
LEAF_ROW_BYTES = 9 * 8 * 4
RAY_BYTES_IN = 12 + 12 + 4 + 1    # o, d, t_max, any-hit flag
RAY_BYTES_OUT = 4 + 4             # t, tri
BLOCK = 1 << 17
SPP = 16


def merged_batch(ref_scene, camera, film, seed: int):
    """The merged wavefront launch of the first 2^17-pixel block (the
    benchmark's copy of the port's ``measure.bench_batches``), made with
    the reference's camera, sampler and plain traversal from ``seed``:
    extension rays leaving the primary hits along cosine-hemisphere
    directions, then shadow rays toward points on the light quad (any
    hit), about half of each half dead (t_max = -inf).  Returns (o, d,
    t_max, any_hit)."""
    from benchmark.reference.frozen.film.filters import get_camera_sample
    from benchmark.reference.frozen.ops.ray import offset_ray_origin
    from benchmark.reference.frozen.ops.sampling import sample_cosine_hemisphere
    from benchmark.reference.frozen.ops.traverse import traverse_raw_plain
    from benchmark.reference.frozen.samplers import ZSobolSampler
    from benchmark.reference.frozen.shapes.triangle import triangle_interaction_from_raw

    tris = ref_scene.triangles
    dev = tris.rows8.device
    w, h = film.resolution
    n = min(BLOCK, w * h)
    i = torch.arange(n, device=dev)
    pixel_xy = torch.stack([i % w, i // w], -1).to(torch.int32)
    sampler = ZSobolSampler(SPP, film.resolution, seed=seed % (1 << 32))
    s = sampler.start_pixel_sample(pixel_xy, 0)
    _, s = sampler.get_1d(s)
    u_f, s = sampler.get_pixel_2d(s)
    u_l, s = sampler.get_2d(s)
    p_film, _, u_l = get_camera_sample(film.filter, pixel_xy, u_f, u_l)
    ray = camera.generate_ray(p_film, u_l)
    o, d = ray.o.contiguous(), ray.d.contiguous()
    inf = torch.full((n,), float("inf"), device=dev)
    never = torch.zeros(n, dtype=torch.bool, device=dev)
    _, tri = traverse_raw_plain(tris.rows8, tris.stack_depth, o, d, inf, never)
    hit_lanes = torch.nonzero(tri >= 0).squeeze(1)
    src = hit_lanes[torch.arange(n, device=dev) % hit_lanes.numel()]
    si = triangle_interaction_from_raw(tris, o[src], d[src], tri[src])
    u2, _ = sampler.get_2d(s)
    wi = si.shading_frame().from_local(sample_cosine_hemisphere(u2))
    bo = offset_ray_origin(si.p, si.n, wi).contiguous()
    bd = wi.contiguous()
    rng = np.random.default_rng(seed)
    lq = tris.light_rows[-2:, 0:9].reshape(2, 3, 3)
    bary = torch.from_numpy(rng.dirichlet([1.0, 1.0, 1.0], n).astype(np.float32)).to(dev)
    which = torch.from_numpy(rng.integers(0, 2, n)).to(dev)
    target = torch.einsum("nk,nkc->nc", bary, lq[which])
    sh_d = (target - bo).contiguous()
    dead = torch.from_numpy(rng.random(2 * n) < 0.5).to(dev)
    t_ext = torch.where(dead[:n], -float("inf"), float("inf"))
    t_sh = torch.where(dead[n:], -float("inf"), 1.0 - 1e-3)
    return (torch.cat([bo, bo]).contiguous(), torch.cat([bd, sh_d]).contiguous(),
            torch.cat([t_ext, t_sh]).contiguous(), torch.arange(2 * n, device=dev) >= n)


def plain_work(ref_scene, batch) -> dict:
    """What the frozen plain traversal needs on ``batch``: its node
    visits, the distinct internal and leaf rows it reads, and the bound."""
    from benchmark.reference.frozen.ops.traverse import traverse_raw_plain

    tris = ref_scene.triangles
    o, d, t_max, want = batch
    touched = torch.zeros(tris.rows8.shape[0], dtype=torch.bool, device=o.device)
    _, _, visits = traverse_raw_plain(tris.rows8, tris.stack_depth, o, d, t_max, want,
                                      return_steps=True, touched=touched)
    leaf = (tris.meta & 15) > 0
    work = {"visits": int(visits.sum()), "internal_rows": int((touched & ~leaf).sum()),
            "leaf_rows": int((touched & leaf).sum()), "rays": int(o.shape[0])}
    return {**work, **bound(**work)}


def bound(visits: int, internal_rows: int, leaf_rows: int, rays: int) -> dict:
    """The least milliseconds of a traversal of ``rays`` rays that needs
    this work, and which of bytes or operations sets it."""
    n_bytes = (internal_rows * INTERNAL_ROW_BYTES + leaf_rows * LEAF_ROW_BYTES
               + rays * (RAY_BYTES_IN + RAY_BYTES_OUT))
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = visits * OPS_PER_VISIT / FP32_OPS_PER_S
    return {"bytes": n_bytes, "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


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
