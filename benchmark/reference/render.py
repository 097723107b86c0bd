"""The plain reference's recomputation of sampled pixels of a frame.

Runs the frozen copy's megakernel path estimator (``li_path``, plain
traversal over its own LBVH) for every (pixel, sample index) of the
pixels asked for, in one call over all their lanes, draws in the order
of the port's ``render_pixel_samples`` (wavelengths, filter, lens), and
resolves each pixel as the film does: the filter-weighted sensor RGB
summed in sample order, over the weight sum, into the output color space.

``precision`` selects the control: ``"bf16"`` rounds each sample's
spectral radiance estimate to bfloat16 before the film; ``"tf32"`` lets
float32 matrix products (the film's color-space matrix) run in TF32.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.frozen.film.filters import get_camera_sample
from benchmark.reference.frozen.integrators.path import li_path
from benchmark.reference.frozen.ops.math import safe_div

PRECISIONS = ("float32", "tf32", "bf16")


def spp_spread(camera, spp: int) -> float:
    """The camera's pixel spread shrunk with the sample count, as the
    port's render gives the estimator."""
    spread = getattr(camera, "pixel_spread", 0.0)
    return spread * max(0.125, 1.0 / np.sqrt(max(spp, 1))) if spread else 0.0


def render_pixels(scene, camera, film, sampler, pixel_xy, spp: int, max_depth: int,
                  precision: str = "float32", chunk: int = 1 << 17):
    """(K, 3) output RGB of the (K, 2) int32 ``pixel_xy`` after ``spp``
    samples each, and the traced ray count.  Lanes are traced ``chunk`` at
    a time."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: expected one of {PRECISIONS}")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    try:
        return _render_pixels(scene, camera, film, sampler, pixel_xy, spp, max_depth,
                              precision, chunk)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _render_pixels(scene, camera, film, sampler, pixel_xy, spp, max_depth, precision, chunk):
    k = pixel_xy.shape[0]
    dev = pixel_xy.device
    # Lane i is pixel i % K, sample index i // K.
    lane_xy = pixel_xy.repeat(spp, 1)
    lane_si = torch.arange(spp, dtype=torch.int64, device=dev).repeat_interleave(k)
    spread = spp_spread(camera, spp)
    rgb_w, weights, rays = [], [], 0.0
    for lo in range(0, lane_xy.shape[0], chunk):
        xy, si = lane_xy[lo:lo + chunk], lane_si[lo:lo + chunk]
        s_state = sampler.start_pixel_sample(xy, si)
        u_lam, s_state = sampler.get_1d(s_state)
        swl = film.sample_wavelengths(u_lam)
        u_filter, s_state = sampler.get_pixel_2d(s_state)
        u_lens, s_state = sampler.get_2d(s_state)
        p_film, weight, u_lens = get_camera_sample(film.filter, xy, u_filter, u_lens)
        ray = camera.generate_ray(p_film, u_lens)
        opts = {"return_stats": True}
        if spread:
            opts["pixel_spread"] = spread
        out, st = li_path(scene, ray, swl, sampler, s_state, max_depth, **opts)
        rays += float(st["rays"])
        bad = torch.any(~torch.isfinite(out), dim=-1)
        l = torch.where(bad[..., None], 0.0, out)
        if precision == "bf16":
            l = l.to(torch.bfloat16).to(torch.float32)
        rgb_w.append(film._clamped_rgb(l, swl) * weight[..., None])
        weights.append(weight)
    rgb_w = torch.cat(rgb_w).reshape(spp, k, 3)
    weights = torch.cat(weights).reshape(spp, k)
    rgb_sum = torch.zeros(k, 3, device=dev)
    w_sum = torch.zeros(k, device=dev)
    for s in range(spp):
        rgb_sum = rgb_sum + rgb_w[s]
        w_sum = w_sum + weights[s]
    rgb = safe_div(rgb_sum, w_sum[..., None])
    m = torch.as_tensor(np.asarray(film.output_rgb_from_sensor_rgb, np.float32), device=dev)
    return torch.einsum("ij,kj->ki", m, rgb), rays
