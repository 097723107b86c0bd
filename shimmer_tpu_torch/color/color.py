"""Chromaticity helpers (port of ``shimmer_tpu/color/color.py``: the host
math the color spaces use)."""

from __future__ import annotations

import numpy as np


def xyz_from_xy_y(xy, y=1.0):
    x, yy = float(xy[0]), float(xy[1])
    if yy == 0.0:
        return np.zeros(3)
    return np.array([x * y / yy, y, (1.0 - x - yy) * y / yy])


def xyz_to_xy(xyz):
    s = xyz[0] + xyz[1] + xyz[2]
    return np.array([xyz[0] / s, xyz[1] / s])
