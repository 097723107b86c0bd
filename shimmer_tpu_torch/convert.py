"""Scene state carried across from the reference package.

``scene_from_numpy`` builds the port's :class:`Scene` from the reference
``Scene``'s leaves as numpy arrays keyed by field path (``triangles.rows8``,
``materials.reflectance``, ``lights.spectrum``, ...) plus its static census
keyed the same way (``triangles.stack_depth``, ``material_kinds``, ...), so
both packages can render from identical tables.  Only the triangle-only
slice converts; anything else in the census raises NotImplementedError.
"""

from __future__ import annotations

import numpy as np
import torch

from shimmer_tpu_torch.config import f32, i32
from shimmer_tpu_torch.lights import lights as lt
from shimmer_tpu_torch.materials import material as mtl
from shimmer_tpu_torch.materials.material import MaterialTable
from shimmer_tpu_torch.scene import Scene
from shimmer_tpu_torch.shapes.triangle import TriangleSceneData

# Census entries the slice cannot render, with the value it requires.
_UNPORTED_CENSUS = {
    "has_spheres": False,
    "has_patches": False,
    "has_instanced": False,
    "has_interface_media": False,
    "has_normal_maps": False,
    "has_bump_maps": False,
    "camera_medium": -1,
    "image_infinite_indices": (),
    "triangles.has_iface_media": False,
    "triangles.differentiable_hits": False,
}
# Array groups whose presence means an unported feature.
_UNPORTED_GROUPS = ("spheres", "patches", "instanced", "media", "env", "textures", "spectra_table")


def scene_from_numpy(arrays: dict, census: dict, device=None) -> Scene:
    """Build a port Scene on ``device`` from reference-scene numpy leaves."""
    for key, want in _UNPORTED_CENSUS.items():
        got = census.get(key, want)
        if (tuple(got) if isinstance(want, tuple) else got) != want:
            raise NotImplementedError(f"scene census {key}={got!r} is not ported yet")
    for key in arrays:
        if key.split(".")[0] in _UNPORTED_GROUPS:
            raise NotImplementedError(f"scene field {key} is not ported yet")
    mtl.check_kinds(tuple(census["material_kinds"]))
    lt.check_kinds(tuple(census["light_kinds"]))

    def a(key):
        return np.asarray(arrays[key])

    tris = TriangleSceneData(
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
    )
    materials = MaterialTable(
        kind=i32(a("materials.kind"), device),
        reflectance=f32(a("materials.reflectance"), device),
    )
    lights = lt.LightData(
        kind=i32(a("lights.kind"), device),
        spectrum=f32(a("lights.spectrum"), device),
        scale=f32(a("lights.scale"), device),
        shape_idx=i32(a("lights.shape_idx"), device),
        shape_kind=i32(a("lights.shape_kind"), device),
        two_sided=torch.from_numpy(a("lights.two_sided").astype(bool)).to(device),
        scene_radius=f32(a("lights.scene_radius"), device).reshape(()),
    )
    return Scene(
        triangles=tris,
        materials=materials,
        lights=lights,
        light_sample_weights=f32(a("light_sample_weights"), device),
        material_kinds=tuple(int(k) for k in census["material_kinds"]),
        light_kinds=tuple(int(k) for k in census["light_kinds"]),
        n_lights=int(census["n_lights"]),
        uniform_infinite_indices=tuple(int(i) for i in census["uniform_infinite_indices"]),
    )
