"""Cameras (port of ``shimmer_tpu/cameras.py``: ``CameraTransform`` with
the default camera-world render space, and the pinhole perspective
camera's ``generate_ray``).  Rays come out in render space."""

from __future__ import annotations

import numpy as np
import torch

from shimmer_tpu_torch.ops.ray import Ray
from shimmer_tpu_torch.ops.transform import Transform
from shimmer_tpu_torch.ops.vecmath import normalize


class CameraTransform:
    """world <-> render <-> camera transform pair; render space has the
    world's axes and the camera at its origin."""

    def __init__(self, world_from_camera: Transform):
        p_camera = world_from_camera.apply_point(torch.zeros(3))
        world_from_render = Transform.translate(p_camera.numpy())
        self.world_from_render = world_from_render
        self.render_from_camera = world_from_render.inverse() @ world_from_camera

    def render_from_world(self) -> Transform:
        return self.world_from_render.inverse()


def _default_screen_window(resolution):
    w, h = resolution
    aspect = w / h
    if aspect > 1.0:
        return (-aspect, -1.0), (aspect, 1.0)
    return (-1.0, -1.0 / aspect), (1.0, 1.0 / aspect)


class PerspectiveCamera:
    """Pinhole perspective camera with the default screen window."""

    def __init__(self, camera_transform, resolution, fov: float = 90.0):
        self.camera_transform = camera_transform
        self.resolution = tuple(resolution)
        screen_from_camera = Transform.perspective(fov, 1e-2, 1000.0)
        (sx0, sy0), (sx1, sy1) = _default_screen_window(resolution)
        ndc_from_screen = Transform.scale(
            1.0 / (sx1 - sx0), 1.0 / (sy1 - sy0), 1.0
        ) @ Transform.translate(np.array([-sx0, -sy1, 0.0]))
        raster_from_ndc = Transform.scale(resolution[0], -resolution[1], 1.0)
        raster_from_screen = raster_from_ndc @ ndc_from_screen
        self.camera_from_raster = screen_from_camera.inverse() @ raster_from_screen.inverse()

    def generate_ray(self, p_film, u_lens):
        """p_film: (..., 2) raster coordinates -> Ray in render space
        (u_lens is unused by a pinhole camera)."""
        p_raster = torch.cat([p_film, torch.zeros_like(p_film[..., :1])], dim=-1)
        p_camera = self.camera_from_raster.apply_point(p_raster)
        o = torch.zeros_like(p_camera)
        d = normalize(p_camera)
        r2c = self.camera_transform.render_from_camera
        return Ray(o=r2c.apply_point(o), d=r2c.apply_vector(d))
