"""The plain reference's recomputation of the first inverse-rendering
steps.

Each step renders every pixel at ``spp`` through the frozen copy's
megakernel path estimator under autograd (``li_path``, plain traversal
over its own LBVH), resolves the image as the film does, takes the L2
loss to the target and its gradient with respect to the given rows of a
scene table (``param``, a dotted path such as ``materials.reflectance``),
then one ``torch.optim.Adam`` step.  Each pixel's value depends on its
own lanes only (box filter, no splats), so the loss is a sum over blocks
of pixels and each block is differentiated on its own, which bounds the
graph held at once.

``precision`` selects the control as in ``reference/render.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference.frozen.film.filters import get_camera_sample
from benchmark.reference.frozen.integrators.path import li_path
from benchmark.reference.frozen.ops.math import safe_div
from benchmark.reference.render import PRECISIONS, spp_spread


def table(obj, param: str):
    """The tensor at dotted path ``param`` of ``obj``."""
    for name in param.split("."):
        obj = getattr(obj, name)
    return obj


def with_rows(obj, param: str, rows, leaf):
    """``obj`` with rows ``rows`` of the tensor at ``param`` taken from
    ``leaf`` (the other rows as they are, detached)."""
    head, _, rest = param.partition(".")
    inner = getattr(obj, head)
    if rest:
        return dataclasses.replace(obj, **{head: with_rows(inner, rest, rows, leaf)})
    parts, k = [], 0
    for r in range(inner.shape[0]):
        if r in rows:
            parts.append(leaf[k:k + 1])
            k += 1
        else:
            parts.append(inner[r:r + 1].detach())
    return dataclasses.replace(obj, **{head: torch.cat(parts)})


def steps(scene, camera, film, sampler_of, target, param: str, rows, spp: int, max_depth: int,
          lr: float, n_steps: int, precision: str = "float32", block: int = 1 << 17,
          fault: str | None = None) -> dict:
    """``n_steps`` Adam steps from ``scene``'s own table, step ``k``
    sampled by ``sampler_of(k)``: each step's loss, the first step's
    gradient, and the parameters' change over the steps.  Pixels are
    differentiated ``block`` at a time.  ``fault`` plants one of the
    faults the control reads: ``"half"`` renders the first half of the
    pixels only and takes the mean over them, ``"altered"`` scales the
    image by 1.01 where it is resolved."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: expected one of {PRECISIONS}")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    try:
        leaf = table(scene, param)[rows].detach().clone().requires_grad_(True)
        before = leaf.detach().clone()
        opt = torch.optim.Adam([leaf], lr=lr)
        losses, grad = [], None
        for k in range(n_steps):
            opt.zero_grad(set_to_none=True)
            losses.append(_loss_backward(scene, camera, film, sampler_of(k), target, param, rows,
                                         leaf, spp, max_depth, precision, block, fault))
            if grad is None:
                grad = leaf.grad.detach().clone()
            opt.step()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return {"losses": losses, "grad": grad.cpu(), "change": (leaf.detach() - before).cpu(),
            "before": before.cpu()}


def _loss_backward(scene, camera, film, sampler, target, param, rows, leaf, spp, max_depth,
                   precision, block, fault) -> float:
    """One step's loss, its gradient left in ``leaf.grad``."""
    dev = leaf.device
    w, h = film.resolution
    m = torch.as_tensor(np.asarray(film.output_rgb_from_sensor_rgb, np.float32), device=dev)
    spread = spp_spread(camera, spp)
    n_px = max(1, w * h // 2) if fault == "half" else w * h
    n_values = n_px * 3
    loss = 0.0
    for lo in range(0, n_px, block):
        i = torch.arange(lo, min(lo + block, n_px), device=dev)
        xy = torch.stack([i % w, i // w], -1).to(torch.int32)
        sc = with_rows(scene, param, rows, leaf)
        rgb_sum = torch.zeros(xy.shape[0], 3, device=dev)
        w_sum = torch.zeros(xy.shape[0], device=dev)
        for s in range(spp):
            s_state = sampler.start_pixel_sample(xy, s)
            u_lam, s_state = sampler.get_1d(s_state)
            swl = film.sample_wavelengths(u_lam)
            u_filter, s_state = sampler.get_pixel_2d(s_state)
            u_lens, s_state = sampler.get_2d(s_state)
            p_film, weight, u_lens = get_camera_sample(film.filter, xy, u_filter, u_lens)
            ray = camera.generate_ray(p_film, u_lens)
            opts = {"pixel_spread": spread} if spread else {}
            out = li_path(sc, ray, swl, sampler, s_state, max_depth, remat=True, **opts)
            bad = torch.any(~torch.isfinite(out), dim=-1)
            l = torch.where(bad[..., None], 0.0, out)
            if precision == "bf16":
                l = l.to(torch.bfloat16).to(torch.float32)
            rgb_sum = rgb_sum + film._clamped_rgb(l, swl) * weight[..., None]
            w_sum = w_sum + weight
        img = torch.einsum("ij,kj->ki", m, safe_div(rgb_sum, w_sum[..., None]))
        if fault == "altered":
            img = img * 1.01
        part = ((img - target.reshape(-1, 3)[lo:lo + xy.shape[0]]) ** 2).sum() / n_values
        part.backward()
        loss += float(part.detach())
    return loss
