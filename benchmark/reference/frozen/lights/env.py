"""Image-based infinite (environment) light (port of
``shimmer_tpu/lights/env.py``): an equal-area octahedral map with a 2-D
piecewise-constant importance distribution.  The map is baked on the host
into sigmoid-coefficient and scale images (each unique color fitted once),
so a lookup on the device is a gather and a closed-form sigmoid.  A lat-long map is resampled into the
equal-area square first, as the reference does.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from benchmark.reference.frozen.config import f32, resolve_device
from benchmark.reference.frozen.ops.math import dot_lanes, to_i32
from benchmark.reference.frozen.ops.sampling import PiecewiseConstant2D, build_piecewise_constant_2d
from benchmark.reference.frozen.ops.transform import Transform
from benchmark.reference.frozen.ops.vecmath import (
    equal_area_sphere_to_square,
    equal_area_square_to_sphere,
    normalize,
)
from benchmark.reference.frozen.spectra.rgb2spec import fit_rgb_coeffs, sigmoid_poly_sample
from benchmark.reference.frozen.spectra.spectrum import dense_sample, spectrum_to_photometric


@dataclasses.dataclass(frozen=True)
class EnvLightData:
    coeffs: torch.Tensor             # (H, W, 3) sigmoid coefficients per texel
    texel_scale: torch.Tensor        # (H, W) 2 max(rgb) per texel
    illum_dense: torch.Tensor        # (471,) the color space's illuminant
    scale: torch.Tensor              # () overall light scale
    render_from_light: torch.Tensor  # (4, 4)
    light_from_render: torch.Tensor  # (4, 4)
    distribution: PiecewiseConstant2D
    scene_radius: torch.Tensor       # ()


def _equal_area_square_to_sphere_np(u, v):
    """The equal-area square -> sphere map in numpy, for the host bake."""
    u = 2.0 * u - 1.0
    v = 2.0 * v - 1.0
    up, vp = np.abs(u), np.abs(v)
    sd = 1.0 - (up + vp)
    d = np.abs(sd)
    r = 1.0 - d
    phi = np.where(r == 0.0, 1.0, (vp - up) / np.maximum(r, 1e-12) + 1.0) * (np.pi / 4.0)
    z = np.copysign(1.0 - r * r, sd)
    cos_phi = np.copysign(np.cos(phi), u)
    sin_phi = np.copysign(np.sin(phi), v)
    s = r * np.sqrt(np.maximum(2.0 - r * r, 0.0))
    return cos_phi * s, sin_phi * s, z


def equirect_to_equal_area(img: np.ndarray, out_res: int | None = None):
    """Resample a lat-long (equirectangular) map into the equal-area square
    (side ``out_res``, default min(max(H, 64), 2048)): bilinear, with the
    longitude wrapping and the latitude clamped at the poles."""
    h, w, c = img.shape
    s = int(out_res or min(max(h, 64), 2048))
    uv = (np.arange(s, dtype=np.float64) + 0.5) / s
    uu, vv = np.meshgrid(uv, uv, indexing="xy")
    x, y, z = _equal_area_square_to_sphere_np(uu, vv)
    theta = np.arccos(np.clip(z, -1.0, 1.0))
    phi = np.mod(np.arctan2(y, x), 2.0 * np.pi)
    fx = phi / (2.0 * np.pi) * w - 0.5
    fy = theta / np.pi * h - 0.5
    x0 = np.floor(fx).astype(np.int64)
    y0 = np.floor(fy).astype(np.int64)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    x0w, x1w = x0 % w, (x0 + 1) % w
    y0c = np.clip(y0, 0, h - 1)
    y1c = np.clip(y0 + 1, 0, h - 1)
    im = np.asarray(img, np.float64)
    return (
        im[y0c, x0w] * (1 - tx) * (1 - ty)
        + im[y0c, x1w] * tx * (1 - ty)
        + im[y1c, x0w] * (1 - tx) * ty
        + im[y1c, x1w] * tx * ty
    )


def build_env_light(
    image_rgb: np.ndarray,
    colorspace,
    scale: float = 1.0,
    render_from_light: Transform | None = None,
    scene_radius: float = 100.0,
    photometric: bool = True,
    device=None,
) -> EnvLightData:
    """Bake an (H, W, 3) linear-RGB map into device tables on ``device``
    (default: the CUDA card).  A map that is not square is taken as
    lat-long and resampled.  ``scale`` is divided by the photometric
    measure of the color space's illuminant when ``photometric``."""
    device = resolve_device(device)
    img = np.asarray(image_rgb, np.float64)
    h, w, _ = img.shape
    if h != w:
        img = equirect_to_equal_area(img)
        h, w, _ = img.shape
    m = np.max(img, axis=-1)
    texel_scale = 2.0 * m
    base = np.where(texel_scale[..., None] > 0.0,
                    img / np.maximum(texel_scale[..., None], 1e-12), 0.0)
    # Fit each unique color once.
    flat = base.reshape(-1, 3).astype(np.float32)
    uniq, inverse = np.unique(flat, axis=0, return_inverse=True)
    coeffs = fit_rgb_coeffs(uniq.astype(np.float64), colorspace)[inverse].reshape(h, w, 3)
    if photometric:
        scale = scale / spectrum_to_photometric(colorspace.illuminant)
    # Importance over the mean of the channels, on [0, 1]^2.
    lum = img.mean(axis=-1)
    rfl = render_from_light or Transform.identity()
    return EnvLightData(
        coeffs=f32(coeffs, device),
        texel_scale=f32(texel_scale, device),
        illum_dense=f32(colorspace.illuminant.to_dense(), device),
        scale=torch.tensor(scale, dtype=torch.float32, device=device),
        render_from_light=f32(rfl.m, device),
        light_from_render=f32(rfl.m_inv, device),
        distribution=build_piecewise_constant_2d(lum, device=device),
        scene_radius=torch.tensor(scene_radius, dtype=torch.float32, device=device),
    )


def _rotate(m, d):
    """The upper 3x3 of ``m`` times directions d (..., 3)."""
    return torch.stack([dot_lanes([(m[i, j], d[..., j]) for j in range(3)]) for i in range(3)],
                       dim=-1)


def _texel(env: EnvLightData, uv):
    """Nearest-texel (row, column) of the map at uv."""
    h, w = env.texel_scale.shape
    x = torch.clamp(to_i32(uv[..., 0] * w), 0, w - 1).long()
    y = torch.clamp(to_i32(uv[..., 1] * h), 0, h - 1).long()
    return y, x


def _radiance(env: EnvLightData, y, x, swl):
    refl = sigmoid_poly_sample(env.coeffs[y, x], swl.lam)
    illum = dense_sample(env.illum_dense, swl.lam)
    return env.scale * env.texel_scale[y, x][..., None] * refl * illum


def _dir_to_uv(env: EnvLightData, d_render):
    return equal_area_sphere_to_square(normalize(_rotate(env.light_from_render, d_render)))


def env_le(env: EnvLightData, ray_d, swl):
    """Radiance of an escaped ray: the nearest texel."""
    return _radiance(env, *_texel(env, _dir_to_uv(env, ray_d)), swl)


def env_sample_li(env: EnvLightData, ref_p, u, swl):
    """Importance-sample a direction from the map: (l, wi, pdf, p_light)."""
    uv, map_pdf = env.distribution.sample(u)
    wi = _rotate(env.render_from_light, equal_area_square_to_sphere(uv))
    pdf = map_pdf / (4.0 * math.pi)
    l = _radiance(env, *_texel(env, uv), swl)
    p_light = ref_p + wi * (2.0 * env.scene_radius)
    return l, wi, pdf, p_light


def env_pdf_li(env: EnvLightData, wi):
    """The solid-angle pdf of env_sample_li giving wi."""
    return env.distribution.pdf_at(_dir_to_uv(env, wi)) / (4.0 * math.pi)
