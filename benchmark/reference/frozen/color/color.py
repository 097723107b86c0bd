"""Chromaticity, chromatic adaptation and transfer encodings (port of
``shimmer_tpu/color/color.py``).  Colors are length-3 arrays and matrices
(3, 3); the host math is numpy, and the encodings also take torch
tensors."""

from __future__ import annotations

import numpy as np
import torch


def xyz_from_xy_y(xy, y=1.0):
    x, yy = float(xy[0]), float(xy[1])
    if yy == 0.0:
        return np.zeros(3)
    return np.array([x * y / yy, y, (1.0 - x - yy) * y / yy])


def xyz_to_xy(xyz):
    s = xyz[0] + xyz[1] + xyz[2]
    return np.array([xyz[0] / s, xyz[1] / s])


# Bradford transformation matrices.
LMS_FROM_XYZ = np.array(
    [
        [0.8951, 0.2664, -0.1614],
        [-0.7502, 1.7135, 0.0367],
        [0.0389, -0.0685, 1.0296],
    ]
)
XYZ_FROM_LMS = np.array(
    [
        [0.986993, -0.147054, 0.159963],
        [0.432305, 0.51836, 0.0492912],
        [-0.00852866, 0.0400428, 0.968487],
    ]
)


def white_balance(src_white_xy, target_white_xy) -> np.ndarray:
    """von Kries adaptation matrix from one white point to another."""
    src_lms = LMS_FROM_XYZ @ xyz_from_xy_y(src_white_xy)
    dst_lms = LMS_FROM_XYZ @ xyz_from_xy_y(target_white_xy)
    return XYZ_FROM_LMS @ np.diag(dst_lms / src_lms) @ LMS_FROM_XYZ


# --- transfer encodings ---


def _xp(v):
    return torch if isinstance(v, torch.Tensor) else np


def srgb_to_linear(v):
    """sRGB decode, elementwise on [0, 1] (numpy or torch)."""
    return _xp(v).where(v <= 0.04045, v / 12.92, ((v + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(v):
    """sRGB encode of values clipped to [0, 1]."""
    v = _xp(v).clip(v, 0.0, 1.0)
    return _xp(v).where(v <= 0.0031308, v * 12.92, 1.055 * v ** (1.0 / 2.4) - 0.055)


def gamma_to_linear(v, gamma):
    return _xp(v).clip(v, 0.0, 1.0) ** gamma


def linear_to_gamma(v, gamma):
    return _xp(v).clip(v, 0.0, 1.0) ** (1.0 / gamma)


class ColorEncoding:
    """'linear', 'sRGB' or ('gamma', g)."""

    def __init__(self, kind: str, gamma: float = 1.0):
        self.kind = kind
        self.gamma = gamma

    @staticmethod
    def from_str(s: str) -> "ColorEncoding":
        s = s.strip()
        if s == "linear":
            return ColorEncoding("linear")
        if s.lower() == "srgb":
            return ColorEncoding("sRGB")
        if s.startswith("gamma"):
            return ColorEncoding("gamma", float(s.split()[1]))
        raise ValueError(f"unknown color encoding: {s}")

    def to_linear(self, v):
        """Decode normalized [0, 1] encoded values to linear."""
        if self.kind == "linear":
            return v
        if self.kind == "sRGB":
            return srgb_to_linear(v)
        return gamma_to_linear(v, self.gamma)

    def from_linear(self, v):
        if self.kind == "linear":
            return v
        if self.kind == "sRGB":
            return linear_to_srgb(v)
        return linear_to_gamma(v, self.gamma)

    def __eq__(self, other):
        return (isinstance(other, ColorEncoding) and self.kind == other.kind
                and self.gamma == other.gamma)

    def __hash__(self):
        return hash((self.kind, self.gamma))


LINEAR = ColorEncoding("linear")
SRGB = ColorEncoding("sRGB")
