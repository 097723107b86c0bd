"""Scene state carried across from the reference package.

``scene_from_numpy`` builds the port's :class:`Scene` from the reference
``Scene``'s leaves as numpy arrays keyed by field path (``triangles.rows8``,
``materials.reflectance``, ``lights.spectrum``, ``spectra_table``, ...)
plus its static census keyed the same way (``triangles.stack_depth``,
``material_kinds``, ...), so both packages can render from identical
tables.  Only the ported slice converts (spheres, triangles, bilinear
patches, instanced triangles, materials, textures, every light kind,
homogeneous media); anything else raises NotImplementedError, and texture
ids, an image light, media, patches or instances without their tables
raise ValueError.
"""

from __future__ import annotations

import numpy as np
import torch

from shimmer_tpu_torch.config import f32, i32, resolve_device
from shimmer_tpu_torch.lights import lights as lt
from shimmer_tpu_torch.lights.env import EnvLightData
from shimmer_tpu_torch.materials import material as mtl
from shimmer_tpu_torch.materials.material import MaterialTable
from shimmer_tpu_torch.media import MediumData
from shimmer_tpu_torch.ops.sampling import PiecewiseConstant2D
from shimmer_tpu_torch.ops.traverse import TraverseConfig
from shimmer_tpu_torch.scene import Scene
from shimmer_tpu_torch.shapes.bilinear import BilinearPatchData
from shimmer_tpu_torch.shapes.instanced import InstancedTriangles
from shimmer_tpu_torch.shapes.sphere import SphereData
from shimmer_tpu_torch.shapes.triangle import TriangleSceneData
from shimmer_tpu_torch.textures import textures as tx

_PATCH_F32 = ("p00", "p10", "p01", "p11", "uv", "area")
_INSTANCED_F32 = ("rows8", "attr_rows", "inst_inv", "inst_fwd", "world_min", "world_max")
_SPHERE_F32 = ("radius", "z_min", "z_max", "theta_z_min", "theta_z_max", "phi_max",
               "object_to_render", "render_to_object")
# MaterialTable columns by type (every column of the reference's table).
_MATERIAL_F32 = ("reflectance", "eta_float", "uroughness", "vroughness", "mix_amount",
                 "thickness", "hg_g", "albedo", "bot_uroughness", "bot_vroughness")
_MATERIAL_I32 = ("kind", "eta_spec", "k_spec", "mix_m1", "mix_m2") + mtl.TEXTURE_COLUMNS
# TextureTable columns by type.
_TEXTURE_I32 = ("kind", "tex_a", "tex_b", "tex_c", "level0_offset", "level0_w", "level0_h",
                "n_levels", "wrap", "filter_kind", "mapping", "level_offsets", "level_sizes")
_TEXTURE_F32 = ("const_value", "mix_amount", "mix_dir", "scale", "uv_scale", "uv_delta",
                "world_to_tex", "planar_vs", "atlas")
_LIGHT_F32 = ("spectrum", "scale", "position", "direction", "cos_falloff_start",
              "cos_falloff_end")
_DIST_F32 = ("func", "cond_cdf", "cond_int", "marg_cdf", "marg_func", "marg_int")
_ENV_F32 = ("coeffs", "texel_scale", "illum_dense", "scale", "render_from_light",
            "light_from_render", "scene_radius")


def _texture_table(arrays: dict, census: dict, device) -> tx.TextureTable:
    def a(c):
        return np.asarray(arrays[f"textures.{c}"])

    return tx.TextureTable(
        **{c: i32(a(c), device) for c in _TEXTURE_I32},
        **{c: f32(a(c), device) for c in _TEXTURE_F32},
        invert=torch.from_numpy(a("invert").astype(bool)).to(device),
        kinds_present=tuple(int(k) for k in census["textures.kinds_present"]),
        has_amount_tex=bool(census["textures.has_amount_tex"]),
        **tx.census_of(a("kind"), a("mapping"), a("filter_kind")),
    )


def _env_light(arrays: dict, census: dict, device) -> EnvLightData:
    """The env tables; the reference's ``env.compensated.*`` table is left
    behind, since no estimator of either package samples from it."""
    def dist(name):
        return PiecewiseConstant2D(
            **{c: f32(arrays[f"env.{name}.{c}"], device) for c in _DIST_F32},
            domain=tuple(map(tuple, census[f"env.{name}.domain"])),
        )

    return EnvLightData(
        **{c: f32(arrays[f"env.{c}"], device) for c in _ENV_F32},
        distribution=dist("distribution"),
    )


def scene_from_numpy(arrays: dict, census: dict, device=None) -> Scene:
    """Build a port Scene on ``device`` (default: the CUDA card) from
    reference-scene numpy leaves.  The reference's ``rows8`` always holds
    watertight leaves, so the table's configuration is
    ``TraverseConfig(leaf="watertight")`` (kernel and winner from the
    environment flags); ``scene.triangles.with_traverse(cfg)`` repacks it
    for Moller-Trumbore leaves.  ``triangles.differentiable_hits`` is
    carried across."""
    mtl.check_kinds(tuple(census["material_kinds"]))
    lt.check_kinds(tuple(census["light_kinds"]))
    has_textures = "textures.kind" in arrays
    tex_cols = {c: np.asarray(arrays[f"materials.{c}"]) for c in mtl.TEXTURE_COLUMNS}
    if not has_textures and any(np.any(v >= 0) for v in tex_cols.values()):
        raise ValueError("the materials carry texture ids but the scene has no texture table")
    has_env = "env.coeffs" in arrays
    if tuple(census.get("image_infinite_indices", ())) and not has_env:
        raise ValueError("the scene has an image infinite light but no env table")
    has_media = "media.g" in arrays
    wants_media = (int(census.get("camera_medium", -1)) >= 0
                   or bool(census.get("has_interface_media", False)))
    if wants_media and not has_media:
        raise ValueError("the scene census names media but the scene has no media table")
    has_patches = bool(census.get("has_patches", False))
    has_instanced = bool(census.get("has_instanced", False))
    if has_patches and "patches.p00" not in arrays:
        raise ValueError("the scene census names patches but the scene has no patch table")
    if has_instanced and "instanced.rows8" not in arrays:
        raise ValueError("the scene census names instances but the scene has no instance table")

    device = resolve_device(device)

    def a(key):
        return np.asarray(arrays[key])

    has_triangles = bool(census["has_triangles"])
    has_spheres = bool(census["has_spheres"])
    tris = None if not has_triangles else TriangleSceneData(
        p=f32(a("triangles.p"), device),
        n=f32(a("triangles.n"), device),
        uv=f32(a("triangles.uv"), device),
        indices=i32(a("triangles.indices"), device),
        orig_indices=i32(a("triangles.orig_indices"), device),
        orig_rev=torch.from_numpy(a("triangles.orig_rev").astype(bool)).to(device),
        tri_area=f32(a("triangles.tri_area"), device),
        rows8=f32(a("triangles.rows8"), device),
        meta=i32(a("triangles.meta"), device),
        attr_rows=f32(a("triangles.attr_rows"), device),
        light_rows=f32(a("triangles.light_rows"), device),
        world_min=f32(a("triangles.world_min"), device),
        world_max=f32(a("triangles.world_max"), device),
        stack_depth=int(census["triangles.stack_depth"]),
        has_normals=bool(census["triangles.has_normals"]),
        has_uv=bool(census["triangles.has_uv"]),
        has_iface_media=bool(census.get("triangles.has_iface_media", False)),
        traverse=TraverseConfig(leaf="watertight"),
        differentiable_hits=bool(census.get("triangles.differentiable_hits", False)),
    )
    spheres = None if not has_spheres else SphereData(
        **{c: f32(a(f"spheres.{c}"), device) for c in _SPHERE_F32},
        reverse_orientation=torch.from_numpy(
            a("spheres.reverse_orientation").astype(bool)).to(device),
        material_id=i32(a("spheres.material_id"), device),
        area_light_id=i32(a("spheres.area_light_id"), device),
    )
    patches = None if not has_patches else BilinearPatchData(
        **{c: f32(a(f"patches.{c}"), device) for c in _PATCH_F32},
        material_id=i32(a("patches.material_id"), device),
        area_light_id=i32(a("patches.area_light_id"), device),
        reverse=torch.from_numpy(a("patches.reverse").astype(bool)).to(device),
        has_uv=bool(census["patches.has_uv"]),
    )
    instanced = None if not has_instanced else InstancedTriangles(
        **{c: f32(a(f"instanced.{c}"), device) for c in _INSTANCED_F32},
        stack_depth=int(census["instanced.stack_depth"]),
        has_normals=bool(census["instanced.has_normals"]),
        has_uv=bool(census["instanced.has_uv"]),
    )
    materials = MaterialTable(
        **{c: f32(a(f"materials.{c}"), device) for c in _MATERIAL_F32},
        **{c: i32(a(f"materials.{c}"), device) for c in _MATERIAL_I32},
        dispersive=torch.from_numpy(a("materials.dispersive").astype(bool)).to(device),
        has_textured_mix=bool(census["materials.has_textured_mix"]),
        layer_medium=bool(census["materials.layer_medium"]),
        has_dispersion=bool(census["materials.has_dispersion"]),
        textured_params=tx.textured_params(tex_cols),
    )
    lights = lt.LightData(
        kind=i32(a("lights.kind"), device),
        **{c: f32(a(f"lights.{c}"), device) for c in _LIGHT_F32},
        shape_idx=i32(a("lights.shape_idx"), device),
        shape_kind=i32(a("lights.shape_kind"), device),
        two_sided=torch.from_numpy(a("lights.two_sided").astype(bool)).to(device),
        scene_radius=f32(a("lights.scene_radius"), device).reshape(()),
    )
    return Scene(
        triangles=tris,
        spheres=spheres,
        patches=patches,
        instanced=instanced,
        env=_env_light(arrays, census, device) if has_env else None,
        textures=_texture_table(arrays, census, device) if has_textures else None,
        media=MediumData(**{c: f32(a(f"media.{c}"), device) for c in ("sigma_a", "sigma_s", "g")})
        if has_media else None,
        camera_medium=int(census.get("camera_medium", -1)),
        has_interface_media=bool(census.get("has_interface_media", False)),
        has_spheres=has_spheres,
        has_triangles=has_triangles,
        has_patches=has_patches,
        has_instanced=has_instanced,
        has_normal_maps=bool(census.get("has_normal_maps", False)),
        has_bump_maps=bool(census.get("has_bump_maps", False)),
        materials=materials,
        lights=lights,
        light_sample_weights=f32(a("light_sample_weights"), device),
        spectra_table=f32(a("spectra_table"), device) if "spectra_table" in arrays else None,
        material_kinds=tuple(int(k) for k in census["material_kinds"]),
        light_kinds=tuple(int(k) for k in census["light_kinds"]),
        n_lights=int(census["n_lights"]),
        uniform_infinite_indices=tuple(int(i) for i in census["uniform_infinite_indices"]),
        image_infinite_indices=tuple(int(i) for i in census.get("image_infinite_indices", ())),
    )
