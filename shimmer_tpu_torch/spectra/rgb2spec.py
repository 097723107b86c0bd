"""RGB -> reflectance-spectrum uplifting with sigmoid polynomials (port of
``shimmer_tpu/spectra/rgb2spec.py``: the fit and its device evaluation).

The polynomial runs in the reference's normalized wavelength basis
x = (lambda - 360) / 470, so coefficients are interchangeable between the
two packages.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from shimmer_tpu_torch.spectra.sampled import LAMBDA_MAX, LAMBDA_MIN
from shimmer_tpu_torch.spectra.spectrum import cie_xyz_dense


def _sigmoid_np(t):
    out = 0.5 + t / (2.0 * np.sqrt(1.0 + t * t))
    return np.where(np.isposinf(t), 1.0, np.where(np.isneginf(t), 0.0, out))


def sigmoid(t):
    """s(t) = 1/2 + t / (2 sqrt(1 + t^2))."""
    return 0.5 + t / (2.0 * torch.sqrt(1.0 + t * t))


def _norm_lambda(lam):
    return (lam - LAMBDA_MIN) / (LAMBDA_MAX - LAMBDA_MIN)


def sigmoid_poly_sample(coeffs, lam):
    """coeffs (..., 3) [c0, c1, c2], lam (..., 4) nm -> (..., 4)."""
    x = _norm_lambda(lam)
    c0 = coeffs[..., 0:1]
    c1 = coeffs[..., 1:2]
    c2 = coeffs[..., 2:3]
    return sigmoid((c0 * x + c1) * x + c2)


@functools.cache
def _basis() -> np.ndarray:
    lam = np.arange(LAMBDA_MIN, LAMBDA_MAX + 1.0)
    x = _norm_lambda(lam)
    return np.stack([x * x, x, np.ones_like(x)], axis=-1)


def _projection_matrix(cs) -> np.ndarray:
    """(3, 471): reflectance table -> linear RGB of ``cs`` under its
    illuminant (the Jakob-Hanika round-trip projection)."""
    cie = cie_xyz_dense().astype(np.float64)
    illum = cs.illuminant.to_dense().astype(np.float64)
    w = float(np.sum(cie[1] * illum))
    return cs.rgb_from_xyz @ (cie * illum[None, :] / w)


def fit_rgb_coeffs(rgb, cs, iters: int = 40) -> np.ndarray:
    """Sigmoid-polynomial coefficients for a batch of (N, 3) albedo colors:
    damped Gauss-Newton in float64 on the host, as in the reference."""
    rgb = np.atleast_2d(np.asarray(rgb, np.float64))
    n = rgb.shape[0]
    a = _projection_matrix(cs)
    b = _basis()
    mean = np.clip(rgb.mean(axis=-1), 1e-4, 1.0 - 1e-4)
    t0 = (2.0 * mean - 1.0) / (2.0 * np.sqrt(mean * (1.0 - mean)))
    c = np.zeros((n, 3))
    c[:, 2] = t0
    lm = np.full(n, 1e-4)
    prev_err = np.full(n, np.inf)
    for _ in range(iters):
        p = c @ b.T
        s = _sigmoid_np(p)
        resid = s @ a.T - rgb
        err = np.sum(resid * resid, axis=-1)
        lm = np.where(err < prev_err, lm * 0.5, lm * 4.0)
        lm = np.clip(lm, 1e-10, 1e4)
        prev_err = np.minimum(prev_err, err)
        ds = 0.5 / np.power(1.0 + p * p, 1.5)
        jac = np.einsum("kl,nl,lc->nkc", a, ds, b)
        jtj = np.einsum("nkc,nkd->ncd", jac, jac)
        jtr = np.einsum("nkc,nk->nc", jac, resid)
        jtj += lm[:, None, None] * np.eye(3)[None]
        c = c - np.linalg.solve(jtj, jtr[..., None])[..., 0]
    return c.astype(np.float32)
