"""Host-side scene assembly (port of ``shimmer_tpu/scene_builder.py``:
triangles, diffuse materials, triangle area lights and uniform infinite
lights)."""

from __future__ import annotations

import numpy as np
import torch

from shimmer_tpu_torch.color.colorspace import RgbColorSpace, get_named_color_space
from shimmer_tpu_torch.config import f32, i32
from shimmer_tpu_torch.lights import lights as lt
from shimmer_tpu_torch.materials import material as mtl
from shimmer_tpu_torch.materials.material import make_material_table
from shimmer_tpu_torch.scene import Scene
from shimmer_tpu_torch.spectra.rgb2spec import fit_rgb_coeffs
from shimmer_tpu_torch.spectra.spectrum import Spectrum, spectrum_to_photometric


def build_scene(
    triangles,
    materials: list[dict] | None = None,
    lights: list[dict] | None = None,
    colorspace: RgbColorSpace | None = None,
    light_sampler: str = "uniform",
    device=None,
) -> Scene:
    """Assemble a device Scene from a TriangleSceneData and material /
    light dicts, as the reference's ``build_scene`` does for a
    triangle-only scene.  ``device`` defaults to the triangles' device."""
    device = triangles.rows8.device if device is None else device
    cs = colorspace or get_named_color_space("srgb")
    materials = materials or []
    lights = lights or []

    mat_dicts = []
    for m in materials:
        m = dict(m)
        if "reflectance" in m and "reflectance_coeffs" not in m:
            m["reflectance_coeffs"] = fit_rgb_coeffs(
                np.asarray(m.pop("reflectance"), np.float64)[None], cs
            )[0]
        mat_dicts.append(m)
    mat_table = make_material_table(mat_dicts, device)
    material_kinds = tuple(sorted({int(m.get("kind", 0)) for m in mat_dicts})) or (mtl.DIFFUSE,)

    lo = triangles.world_min.cpu().numpy()
    hi = triangles.world_max.cpu().numpy()
    scene_radius = max(
        100.0,
        float(np.linalg.norm(hi - lo) * 0.5 + np.linalg.norm((hi + lo) * 0.5)),
    )

    n_l = len(lights)
    kind = np.zeros(n_l, np.int32)
    spectrum = np.zeros((n_l, 471), np.float32)
    scale = np.ones(n_l, np.float32)
    shape_idx = np.full(n_l, -1, np.int32)
    shape_kind = np.zeros(n_l, np.int32)
    two_sided = np.zeros(n_l, bool)
    power = np.ones(n_l, np.float32)
    tri_area = triangles.tri_area.cpu().numpy()
    for i, ld in enumerate(lights):
        if ld["kind"] not in lt.PORTED_KINDS:
            raise NotImplementedError(f"light kind {ld['kind']} is not ported yet")
        if ld["kind"] == lt.AREA and ld.get("shape_kind", 0) != lt.TRIANGLE_SHAPE:
            raise NotImplementedError("only triangle area lights are ported")
        kind[i] = ld["kind"]
        spec: Spectrum = ld["spectrum"]
        spectrum[i] = spec.to_dense()
        s = float(ld.get("scale", 1.0))
        if ld.get("photometric", False):
            s /= spectrum_to_photometric(spec)
        scale[i] = s
        shape_idx[i] = ld.get("shape_idx", -1)
        shape_kind[i] = ld.get("shape_kind", 0)
        two_sided[i] = bool(ld.get("two_sided", False))
        lum = float(np.mean(spectrum[i])) * s
        if ld["kind"] == lt.AREA:
            area = float(tri_area[ld["shape_idx"]])
            power[i] = lum * area * np.pi * (2.0 if two_sided[i] else 1.0)
        else:
            power[i] = lum * 4.0 * np.pi * scene_radius**2

    light_data = lt.LightData(
        kind=i32(kind, device),
        spectrum=f32(spectrum, device),
        scale=f32(scale, device),
        shape_idx=i32(shape_idx, device),
        shape_kind=i32(shape_kind, device),
        two_sided=torch.from_numpy(two_sided).to(device),
        scene_radius=torch.tensor(scene_radius, dtype=torch.float32, device=device),
    )
    if light_sampler == "power":
        weights = np.maximum(power, 1e-12)
    elif light_sampler == "uniform":
        weights = np.ones(n_l, np.float32)
    else:
        raise ValueError(f"unknown light sampler {light_sampler!r}")
    return Scene(
        triangles=triangles,
        materials=mat_table,
        lights=light_data,
        light_sample_weights=f32(weights, device),
        material_kinds=material_kinds,
        light_kinds=tuple(sorted({int(k) for k in kind})),
        n_lights=n_l,
        uniform_infinite_indices=tuple(
            int(i) for i in np.nonzero(kind == lt.UNIFORM_INFINITE)[0]
        ),
    )
