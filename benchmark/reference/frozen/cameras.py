"""Cameras (port of ``shimmer_tpu/cameras.py``): the perspective camera
with its thin lens, the orthographic camera and the spherical camera
(equal-area and equirectangular), each with ``generate_ray`` and
``generate_ray_differential``.  Rays come out in render space: the
camera's own space (``camera``), the world's axes with the camera at the
origin (``cameraworld``, the default) or the world (``world``).

The transforms are composed on the host in numpy as in the reference, so
the matrices are the same bits; applying them adds in the order
``ops/transform.py`` spells out.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.frozen.ops.math import lerp
from benchmark.reference.frozen.ops.ray import Ray, RayDifferential
from benchmark.reference.frozen.ops.sampling import sample_uniform_disk_concentric
from benchmark.reference.frozen.ops.transform import Transform
from benchmark.reference.frozen.ops.vecmath import equal_area_square_to_sphere, normalize, vec


class CameraTransform:
    """world <-> render <-> camera transform pair."""

    def __init__(self, world_from_camera: Transform, rendering_space: str = "cameraworld"):
        rendering_space = rendering_space.lower()
        if rendering_space == "camera":
            world_from_render = world_from_camera
        elif rendering_space == "cameraworld":
            p_camera = world_from_camera.apply_point(torch.zeros(3))
            world_from_render = Transform.translate(p_camera.numpy())
        elif rendering_space == "world":
            world_from_render = Transform.identity()
        else:
            raise ValueError(f"unknown rendering coordinate system: {rendering_space}")
        self.world_from_render = world_from_render
        self.render_from_camera = world_from_render.inverse() @ world_from_camera

    def render_from_world(self) -> Transform:
        return self.world_from_render.inverse()


def _vec3(x, y, z, like):
    return torch.tensor([x, y, z], dtype=torch.float32, device=like.device)


class CameraBase:
    def __init__(self, camera_transform: CameraTransform, resolution,
                 shutter_open: float = 0.0, shutter_close: float = 1.0):
        self.camera_transform = camera_transform
        self.resolution = tuple(resolution)  # (w, h)
        self.shutter_open = float(shutter_open)
        self.shutter_close = float(shutter_close)

    def sample_time(self, u):
        return lerp(u, self.shutter_open, self.shutter_close)

    def _to_render(self, o, d) -> Ray:
        r2c = self.camera_transform.render_from_camera
        return Ray(o=r2c.apply_point(o), d=r2c.apply_vector(d))


def _default_screen_window(resolution):
    w, h = resolution
    aspect = w / h
    if aspect > 1.0:
        return (-aspect, -1.0), (aspect, 1.0)
    return (-1.0, -1.0 / aspect), (1.0, 1.0 / aspect)


class _ProjectiveCamera(CameraBase):
    """The raster <-> screen <-> camera transforms, the screen window and
    the thin lens's radius and focal distance."""

    def __init__(self, camera_transform, resolution, screen_from_camera: Transform,
                 screen_window=None, lens_radius: float = 0.0, focal_distance: float = 1e6,
                 **kw):
        super().__init__(camera_transform, resolution, **kw)
        if screen_window is None:
            screen_window = _default_screen_window(resolution)
        (sx0, sy0), (sx1, sy1) = screen_window
        # The reference builds this translation from a float32 array.
        shift = np.array([-sx0, -sy1, 0.0], np.float32)
        ndc_from_screen = Transform.scale(
            1.0 / (sx1 - sx0), 1.0 / (sy1 - sy0), 1.0
        ) @ Transform.translate(shift)
        raster_from_ndc = Transform.scale(resolution[0], -resolution[1], 1.0)
        self.raster_from_screen = raster_from_ndc @ ndc_from_screen
        self.screen_from_raster = self.raster_from_screen.inverse()
        self.camera_from_raster = screen_from_camera.inverse() @ self.screen_from_raster
        self.screen_from_camera = screen_from_camera
        self.lens_radius = float(lens_radius)
        self.focal_distance = float(focal_distance)

    def _raster_point(self, p_film):
        p_raster = torch.cat([p_film, torch.zeros_like(p_film[..., :1])], dim=-1)
        return self.camera_from_raster.apply_point(p_raster)


class PerspectiveCamera(_ProjectiveCamera):
    """Pinhole or thin-lens perspective camera."""

    def __init__(self, camera_transform, resolution, fov: float = 90.0, screen_window=None,
                 lens_radius: float = 0.0, focal_distance: float = 1e6, **kw):
        super().__init__(camera_transform, resolution, Transform.perspective(fov, 1e-2, 1000.0),
                         screen_window, lens_radius, focal_distance, **kw)
        self.fov = float(fov)
        # Angular size of one pixel, for the approximate texture footprints.
        self.pixel_spread = float(2.0 * np.tan(np.deg2rad(fov) / 2.0) / resolution[1])
        c2r = self.camera_from_raster
        zero = c2r.apply_point(torch.zeros(3))
        self.dx_camera = (c2r.apply_point(torch.tensor([1.0, 0.0, 0.0])) - zero).numpy()
        self.dy_camera = (c2r.apply_point(torch.tensor([0.0, 1.0, 0.0])) - zero).numpy()

    def _camera_ray(self, p_film, u_lens):
        p_camera = self._raster_point(p_film)
        o = torch.zeros_like(p_camera)
        d = normalize(p_camera)
        if self.lens_radius > 0.0:
            p_lens = self.lens_radius * sample_uniform_disk_concentric(u_lens)
            ft = self.focal_distance / d[..., 2]
            p_focus = o + ft[..., None] * d
            o = torch.cat([p_lens, torch.zeros_like(p_lens[..., :1])], dim=-1)
            d = normalize(p_focus - o)
        return o, d, p_camera

    def generate_ray(self, p_film, u_lens):
        """p_film: (..., 2) raster coordinates -> Ray in render space."""
        o, d, _ = self._camera_ray(p_film, u_lens)
        return self._to_render(o, d)

    def generate_ray_differential(self, p_film, u_lens):
        """The main ray and the rays one pixel over in x and y (through
        the focus plane with a lens)."""
        o, d, p_camera = self._camera_ray(p_film, u_lens)
        dx = torch.as_tensor(self.dx_camera, device=p_camera.device)
        dy = torch.as_tensor(self.dy_camera, device=p_camera.device)
        if self.lens_radius > 0.0:
            def focus_dir(dp):
                dd = normalize(p_camera + dp)
                ft = self.focal_distance / dd[..., 2]
                return normalize(ft[..., None] * dd - o)

            rx_d, ry_d = focus_dir(dx), focus_dir(dy)
        else:
            rx_d = normalize(p_camera + dx)
            ry_d = normalize(p_camera + dy)
        r2c = self.camera_transform.render_from_camera
        ray = self._to_render(o, d)
        return RayDifferential(
            ray=ray,
            rx_o=r2c.apply_point(o), rx_d=r2c.apply_vector(rx_d),
            ry_o=r2c.apply_point(o), ry_d=r2c.apply_vector(ry_d),
            has_differentials=torch.ones(ray.o.shape[:-1], dtype=torch.bool, device=o.device),
        )


class OrthographicCamera(_ProjectiveCamera):
    """Orthographic projection, with an optional thin lens."""

    def __init__(self, camera_transform, resolution, screen_window=None,
                 lens_radius: float = 0.0, focal_distance: float = 1e6, **kw):
        super().__init__(camera_transform, resolution, Transform.orthographic(0.0, 1.0),
                         screen_window, lens_radius, focal_distance, **kw)

    def generate_ray(self, p_film, u_lens):
        o = self._raster_point(p_film)
        d = torch.broadcast_to(_vec3(0.0, 0.0, 1.0, o), o.shape)
        if self.lens_radius > 0.0:
            p_lens = self.lens_radius * sample_uniform_disk_concentric(u_lens)
            ft = self.focal_distance / d[..., 2]
            p_focus = o + ft[..., None] * d
            o = torch.cat([p_lens, o[..., 2:]], dim=-1)
            d = normalize(p_focus - o)
        return self._to_render(o, d)

    def generate_ray_differential(self, p_film, u_lens):
        ray = self.generate_ray(p_film, u_lens)
        r2c = self.camera_transform.render_from_camera
        c2r = self.camera_from_raster
        dx = r2c.apply_vector(c2r.apply_vector(_vec3(1.0, 0.0, 0.0, ray.o)))
        dy = r2c.apply_vector(c2r.apply_vector(_vec3(0.0, 1.0, 0.0, ray.o)))
        return RayDifferential(
            ray=ray, rx_o=ray.o + dx, rx_d=ray.d, ry_o=ray.o + dy, ry_d=ray.d,
            has_differentials=torch.ones(ray.o.shape[:-1], dtype=torch.bool,
                                         device=ray.o.device),
        )


class SphericalCamera(CameraBase):
    """360-degree camera, equal-area or equirectangular mapping."""

    def __init__(self, camera_transform, resolution, mapping: str = "equalarea", **kw):
        super().__init__(camera_transform, resolution, **kw)
        self.mapping = mapping

    def generate_ray(self, p_film, u_lens):
        w, h = self.resolution
        uv = torch.stack([p_film[..., 0] / w, p_film[..., 1] / h], dim=-1)
        if self.mapping == "equalarea":
            uv = torch.stack([uv[..., 0], 1.0 - uv[..., 1]], dim=-1)
            d = equal_area_square_to_sphere(uv)
        else:  # equirectangular
            theta = math.pi * uv[..., 1]
            phi = 2.0 * math.pi * uv[..., 0]
            st = torch.sin(theta)
            d = vec(st * torch.sin(phi), torch.cos(theta), -st * torch.cos(phi))
        # The y-up mapping turned into the z-up camera space.
        d = torch.stack([-d[..., 2], -d[..., 0], d[..., 1]], dim=-1)
        return self._to_render(torch.zeros_like(d), d)

    def generate_ray_differential(self, p_film, u_lens):
        ray = self.generate_ray(p_film, u_lens)
        one_x = torch.tensor([1.0, 0.0], device=p_film.device)
        one_y = torch.tensor([0.0, 1.0], device=p_film.device)
        rx = self.generate_ray(p_film + one_x, u_lens)
        ry = self.generate_ray(p_film + one_y, u_lens)
        return RayDifferential(
            ray=ray, rx_o=rx.o, rx_d=rx.d, ry_o=ry.o, ry_d=ry.d,
            has_differentials=torch.ones(ray.o.shape[:-1], dtype=torch.bool,
                                         device=ray.o.device),
        )
