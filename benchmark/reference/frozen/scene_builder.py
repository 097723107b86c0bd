"""Host-side scene assembly (port of ``shimmer_tpu/scene_builder.py``:
analytic spheres, triangles, bilinear patches and instanced triangles,
materials of every ported kind with the dense spectra table their IORs
index and the texture table their texture columns index, point, spot and
distant lights, area lights on spheres, triangles and patches, uniform
infinite lights, the image environment light and homogeneous media)."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.frozen.color.colorspace import RgbColorSpace, get_named_color_space
from benchmark.reference.frozen.config import f32, i32, resolve_device
from benchmark.reference.frozen.lights import lights as lt
from benchmark.reference.frozen.materials import material as mtl
from benchmark.reference.frozen.materials.material import make_material_table
from benchmark.reference.frozen.media import make_media_table
from benchmark.reference.frozen.ops.transform import Transform
from benchmark.reference.frozen.scene import Scene
from benchmark.reference.frozen.shapes.bilinear import make_bilinear_data
from benchmark.reference.frozen.shapes.sphere import make_sphere_data, sphere_area
from benchmark.reference.frozen.spectra.rgb2spec import fit_rgb_coeffs
from benchmark.reference.frozen.spectra.spectrum import Spectrum, spectrum_to_photometric


def build_scene(
    triangles=None,
    materials: list[dict] | None = None,
    lights: list[dict] | None = None,
    colorspace: RgbColorSpace | None = None,
    light_sampler: str = "uniform",
    spectra_table=None,
    device=None,
    spheres: list[dict] | None = None,
    render_from_world: Transform | None = None,
    textures=None,
    env=None,
    env_spec: dict | None = None,
    media: list[dict] | None = None,
    camera_medium: int = -1,
    patches: list[dict] | None = None,
    instanced=None,
) -> Scene:
    """Assemble a device Scene from a TriangleSceneData (or None), sphere
    dicts and material / light dicts, as the reference's ``build_scene``
    does.  Sphere dicts carry ``radius``, ``z_min``, ``z_max``,
    ``phi_max`` (degrees), ``reverse_orientation``, ``material_id``,
    ``area_light_id`` and either ``object_to_render`` or
    ``object_to_world`` (composed with ``render_from_world`` here).
    Material dicts carry ``kind`` plus the per-kind parameters of
    ``materials.material.make_material_table``; ``reflectance`` may be an
    RGB triple (fit to sigmoid coefficients here).  ``spectra_table`` is
    the (K, 471) dense table that ``eta_spec`` / ``k_spec`` index, and
    ``textures`` the TextureTable the ``tex_*``, ``normal_tex`` and
    ``displacement_tex`` columns index.  An image infinite light reads
    ``env`` (an EnvLightData), or is baked here from ``env_spec`` (``image``,
    ``scale``, ``render_from_light``) with the scene's radius.  Point and
    spot lights carry a world-space ``position``, spot and distant lights a
    ``direction`` (spot: ``cone_angle`` and ``cone_delta`` in degrees).
    ``media`` are the medium dicts of ``media.make_media_table`` and
    ``camera_medium`` the index of the medium the camera sits in (-1:
    vacuum).  ``patches`` are the patch dicts of
    ``shapes.bilinear.make_bilinear_data`` (world space, composed with
    ``render_from_world`` here) and ``instanced`` an InstancedTriangles.
    ``device`` defaults to the triangles' device, else the instanced
    table's, else the CUDA card."""
    if device is None:
        built = triangles if triangles is not None else instanced
        device = built.rows8.device if built is not None else resolve_device(None)
    cs = colorspace or get_named_color_space("srgb")
    r_from_w = render_from_world or Transform.identity()
    spheres = [dict(sp) for sp in (spheres or [])]
    for sp in spheres:
        o2w = sp.pop("object_to_world", None)
        if "object_to_render" not in sp:
            sp["object_to_render"] = r_from_w @ o2w if o2w is not None else r_from_w
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

    sphere_data = make_sphere_data(spheres, device) if spheres else None
    patch_data = (make_bilinear_data(patches, render_from_object=r_from_w, device=device)
                  if patches else None)

    # Scene bounds radius for the infinite lights: the spheres' extent (or
    # 100 without spheres), then at least the bounding sphere of the
    # triangles and of the instances (not of the patches, as in the
    # reference).
    if spheres:
        centers = np.stack([np.asarray(s["object_to_render"].m)[0:3, 3] for s in spheres])
        radii = np.array([s.get("radius", 1.0) for s in spheres])
        scene_radius = float(np.max(np.linalg.norm(centers, axis=-1) + radii))
    else:
        scene_radius = 100.0
    for geom in (triangles, instanced):
        if geom is None:
            continue
        lo = geom.world_min.cpu().numpy()
        hi = geom.world_max.cpu().numpy()
        scene_radius = max(
            scene_radius,
            float(np.linalg.norm(hi - lo) * 0.5 + np.linalg.norm((hi + lo) * 0.5)),
        )

    # The deferred env bake sees the computed scene radius.
    if env is None and env_spec is not None:
        from benchmark.reference.frozen.lights.env import build_env_light

        env = build_env_light(env_spec["image"], cs, scale=float(env_spec.get("scale", 1.0)),
                              render_from_light=env_spec.get("render_from_light"),
                              scene_radius=scene_radius, device=device)

    n_l = len(lights)
    kind = np.zeros(n_l, np.int32)
    spectrum = np.zeros((n_l, 471), np.float32)
    scale = np.ones(n_l, np.float32)
    position = np.zeros((n_l, 3), np.float32)
    direction = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (n_l, 1))
    cf_start = np.ones(n_l, np.float32)
    cf_end = np.ones(n_l, np.float32)
    shape_idx = np.full(n_l, -1, np.int32)
    shape_kind = np.zeros(n_l, np.int32)
    two_sided = np.zeros(n_l, bool)
    power = np.ones(n_l, np.float32)
    tri_area = triangles.tri_area.cpu().numpy() if triangles is not None else None
    sph_area = sphere_area(sphere_data).cpu().numpy() if sphere_data is not None else None
    patch_area = patch_data.area.cpu().numpy() if patch_data is not None else None
    for i, ld in enumerate(lights):
        if ld["kind"] not in lt.PORTED_KINDS:
            raise NotImplementedError(f"light kind {ld['kind']} is not ported yet")
        if ld["kind"] == lt.AREA and ld.get("shape_kind", 0) not in (
                lt.SPHERE_SHAPE, lt.TRIANGLE_SHAPE, lt.PATCH_SHAPE):
            raise NotImplementedError(
                f"area lights on shape kind {ld.get('shape_kind', 0)} are not ported yet")
        kind[i] = ld["kind"]
        spec: Spectrum = ld["spectrum"]
        spectrum[i] = spec.to_dense()
        s = float(ld.get("scale", 1.0))
        if ld.get("photometric", False):
            s /= spectrum_to_photometric(spec)
        scale[i] = s
        # To render space in float32, as the reference does.
        pos_w = torch.from_numpy(np.asarray(ld.get("position", (0, 0, 0)), np.float32))
        position[i] = r_from_w.apply_point(pos_w).numpy()
        d_w = torch.from_numpy(np.asarray(ld.get("direction", (0, 0, 1)), np.float32))
        d = r_from_w.apply_vector(d_w).numpy()
        direction[i] = d / max(np.linalg.norm(d), 1e-12)
        cf_start[i] = np.cos(np.deg2rad(ld.get("cone_angle", 30.0) - ld.get("cone_delta", 5.0)))
        cf_end[i] = np.cos(np.deg2rad(ld.get("cone_angle", 30.0)))
        shape_idx[i] = ld.get("shape_idx", -1)
        shape_kind[i] = ld.get("shape_kind", 0)
        two_sided[i] = bool(ld.get("two_sided", False))
        lum = float(np.mean(spectrum[i])) * s
        if ld["kind"] == lt.AREA:
            if shape_kind[i] == lt.SPHERE_SHAPE and sph_area is not None:
                area = float(sph_area[ld["shape_idx"]])
            elif shape_kind[i] == lt.PATCH_SHAPE and patch_area is not None:
                area = float(patch_area[ld["shape_idx"]])
            elif tri_area is not None:
                area = float(tri_area[ld["shape_idx"]])
            else:
                area = 1.0
            power[i] = lum * area * np.pi * (2.0 if two_sided[i] else 1.0)
        elif ld["kind"] in (lt.UNIFORM_INFINITE, lt.IMAGE_INFINITE, lt.DISTANT):
            power[i] = lum * 4.0 * np.pi * scene_radius**2
        else:
            power[i] = lum * 4.0 * np.pi

    light_data = lt.LightData(
        kind=i32(kind, device),
        spectrum=f32(spectrum, device),
        scale=f32(scale, device),
        position=f32(position, device),
        direction=f32(direction, device),
        cos_falloff_start=f32(cf_start, device),
        cos_falloff_end=f32(cf_end, device),
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
    media_table = make_media_table(media, cs, device) if media else None
    if media_table is None:
        camera_medium = -1
    return Scene(
        triangles=triangles,
        spheres=sphere_data,
        patches=patch_data,
        instanced=instanced,
        env=env,
        textures=textures,
        media=media_table,
        camera_medium=int(camera_medium),
        has_interface_media=media_table is not None and triangles is not None
        and triangles.has_iface_media,
        has_spheres=sphere_data is not None,
        has_triangles=triangles is not None,
        has_patches=patch_data is not None,
        has_instanced=instanced is not None,
        has_normal_maps=any(m.get("normal_tex", -1) >= 0 for m in mat_dicts),
        has_bump_maps=any(m.get("displacement_tex", -1) >= 0 for m in mat_dicts),
        materials=mat_table,
        lights=light_data,
        light_sample_weights=f32(weights, device),
        spectra_table=None if spectra_table is None else f32(spectra_table, device),
        material_kinds=material_kinds,
        light_kinds=tuple(sorted({int(k) for k in kind})),
        n_lights=n_l,
        uniform_infinite_indices=tuple(
            int(i) for i in np.nonzero(kind == lt.UNIFORM_INFINITE)[0]
        ),
        image_infinite_indices=tuple(int(i) for i in np.nonzero(kind == lt.IMAGE_INFINITE)[0]),
    )
