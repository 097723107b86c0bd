"""A cell's scene, made from its configuration file and handed to either
side: the port (``shimmer_tpu_torch``) or the frozen reference
(``benchmark.reference.frozen``), which share one construction API.

The configuration's ``scene`` names its builder, ``scenes/<scene>.py``,
which has ``geometry(config) -> dict`` (the arrays both sides build
their tables from) and ``build(api, config, geom, device) -> (scene,
camera, film)``; :func:`camera_film` and :func:`sampler` are shared.
"""

from __future__ import annotations

import importlib
import types

import numpy as np

PORT = "shimmer_tpu_torch"
REFERENCE = "benchmark.reference.frozen"
_MODULES = ("cameras", "color.colorspace", "film.film", "film.filters", "lights.lights",
            "materials.material", "ops.transform", "scene_builder", "shapes.mesh",
            "shapes.triangle", "spectra.spectrum", "samplers")
_FILTERS = {"box": "BoxFilter"}
_SAMPLERS = {"zsobol": "ZSobolSampler"}


def side(package: str) -> types.SimpleNamespace:
    """The construction modules of ``package``, by their last name."""
    return types.SimpleNamespace(**{m.rsplit(".", 1)[-1]: importlib.import_module(
        f"{package}.{m}") for m in _MODULES})


def builder(config: dict, root=None):
    """The configuration's scene builder module."""
    from benchmark import harness

    return harness.module("scenes", config["scene"], root or harness.ROOT)


def geometry(config: dict, root=None) -> dict:
    return builder(config, root).geometry(config)


def build(api, config: dict, geom: dict, device, root=None):
    """(scene, camera, film) of ``config`` on ``device``, built by ``api``
    (:func:`side`) from ``geom`` (:func:`geometry`)."""
    return builder(config, root).build(api, config, geom, device)


def camera_film(api, config: dict):
    """The configuration's perspective camera and RGB film."""
    res = tuple(config["resolution"])
    cam_cfg, film_cfg = config["camera"], config["film"]
    cs = api.colorspace.get_named_color_space(film_cfg["colorspace"])
    eye, look, up = (np.array(cam_cfg[k], np.float32) for k in ("eye", "look", "up"))
    ct = api.cameras.CameraTransform(api.transform.Transform.look_at(eye, look, up))
    cam = api.cameras.PerspectiveCamera(ct, res, fov=float(cam_cfg["fov"]))
    filt = getattr(api.filters, _FILTERS[film_cfg["filter"]])()
    film = api.film.RgbFilm(res, filt, api.film.PixelSensor(cs), cs)
    return cam, film, cs


def sampler(api, config: dict, resolution, seed: int, spp: int):
    """The configuration's sampler kind at ``spp`` samples a pixel."""
    kind = getattr(api.samplers, _SAMPLERS[config["sampler"]["kind"]])
    return kind(int(spp), tuple(resolution), seed=int(seed) % (1 << 32))
