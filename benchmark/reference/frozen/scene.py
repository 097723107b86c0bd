"""Device scene: flat tables plus the static census (port of
``shimmer_tpu/scene.py``: analytic spheres, triangles, bilinear patches
and instanced triangles, textures, the image environment light and
homogeneous media).

The census (which material, light and shape kinds exist) is plain Python
attributes that pick code paths, as the reference's static fields do
under jit.  A scene of world triangles alone takes the merged trace's fast
path; a scene with spheres, patches or instances traces every lane through
the union (``scene_intersect``) and slices the result.
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference.frozen.lights.lights import LightData
from benchmark.reference.frozen.materials.material import MaterialTable
from benchmark.reference.frozen.ops.math import stop_gradient
from benchmark.reference.frozen.ops.sampling import sample_discrete
from benchmark.reference.frozen.shapes.bilinear import BilinearPatchData, bilinear_intersect, bilinear_occluded
from benchmark.reference.frozen.shapes.instanced import (
    InstancedTriangles,
    instanced_intersect,
    instanced_occluded,
)
from benchmark.reference.frozen.shapes.sphere import SphereData, sphere_intersect
from benchmark.reference.frozen.shapes.triangle import (
    TriangleSceneData,
    _traverse_raw,
    triangle_interaction_from_raw,
    triangle_scene_intersect,
    triangle_scene_occluded,
)


@dataclasses.dataclass(frozen=True)
class Scene:
    triangles: TriangleSceneData | None
    materials: MaterialTable
    lights: LightData
    light_sample_weights: torch.Tensor  # (L,) pmf weights
    spectra_table: torch.Tensor | None = None  # (K, 471) dense spectra (IORs)
    # --- static census ---
    material_kinds: tuple = ()
    light_kinds: tuple = ()
    n_lights: int = 0
    uniform_infinite_indices: tuple = ()
    spheres: SphereData | None = None
    env: object | None = None        # EnvLightData (lights/env.py)
    textures: object | None = None   # TextureTable (textures/textures.py)
    media: object | None = None      # MediumData (media.py)
    patches: BilinearPatchData | None = None
    instanced: InstancedTriangles | None = None
    # The medium the camera sits in (index into media; -1: vacuum).
    camera_medium: int = -1
    # Some triangle declares a MediumInterface: per-lane medium tracking,
    # interface crossing and the shadow march.
    has_interface_media: bool = False
    image_infinite_indices: tuple = ()
    has_spheres: bool = False
    has_triangles: bool = False
    has_patches: bool = False
    has_instanced: bool = False
    has_normal_maps: bool = False
    has_bump_maps: bool = False

    @property
    def device(self):
        return self.materials.kind.device

    def to(self, device) -> "Scene":
        """The same scene with every table on ``device``."""
        return _tensors_to(self, device)


def _tensors_to(obj, device):
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            changes[f.name] = v.to(device)
        elif dataclasses.is_dataclass(v):
            changes[f.name] = _tensors_to(v, device)
    return dataclasses.replace(obj, **changes)


def grad_tensor_fields(obj, path: tuple = ()) -> list:
    """(path, tensor) of every tensor field of ``obj`` that requires grad,
    nested tables included (the walk of ``Scene.to``); a path is the
    tuple of field names from ``obj`` down."""
    found = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            if v.requires_grad:
                found.append((path + (f.name,), v))
        elif dataclasses.is_dataclass(v):
            found.extend(grad_tensor_fields(v, path + (f.name,)))
    return found


def with_tensor_fields(obj, fields):
    """``obj`` with each (path, tensor) of ``fields`` put in at its path."""
    for path, value in fields:
        obj = _replace_at(obj, path, value)
    return obj


def _replace_at(obj, path: tuple, value):
    head = path[0]
    if len(path) > 1:
        value = _replace_at(getattr(obj, head), path[1:], value)
    return dataclasses.replace(obj, **{head: value})


def scene_intersect(scene: Scene, ray_o, ray_d, t_max, want_any=False):
    """Closest hit over every shape of the scene, the legs in the
    reference's order (spheres, triangles, patches, instances), so the
    earlier leg keeps an exact tie at equal t.  Lanes flagged in
    ``want_any`` stop the triangle and instanced legs at their first
    accepted hit (only ``valid`` means anything there)."""
    si = None
    if scene.has_spheres:
        si = sphere_intersect(scene.spheres, ray_o, ray_d, t_max)
    if scene.has_triangles:
        si_t = triangle_scene_intersect(scene.triangles, ray_o, ray_d, t_max,
                                        want_any=want_any)
        si = si_t if si is None else _closer(si, si_t)
    if scene.has_patches:
        si_p = bilinear_intersect(scene.patches, ray_o, ray_d, t_max)
        si = si_p if si is None else _closer(si, si_p)
    if scene.has_instanced:
        si_i = instanced_intersect(scene.instanced, ray_o, ray_d, t_max, want_any=want_any)
        si = si_i if si is None else _closer(si, si_i)
    if si is None:
        raise ValueError("the scene has no geometry")
    return si


def scene_intersect_merged(scene: Scene, ray_o, ray_d, t_max, n_ext):
    """Wavefront merged trace: lanes [:n_ext] are extension rays
    (closest hit, full interaction), lanes [n_ext:] are shadow rays (any
    hit, occlusion only).  Returns (si_ext, occluded).

    World triangles alone: one raw traversal over all lanes, interactions
    for the extension slice only.  With spheres, patches or instances: the
    union over all lanes, sliced; a shadow lane's triangle and instanced
    legs stop at its first hit, so only its ``valid`` is read."""
    n_all = ray_o.shape[0]
    want_any = torch.arange(n_all, device=ray_o.device) >= n_ext
    if scene.has_triangles and not (scene.has_spheres or scene.has_patches
                                    or scene.has_instanced):
        _, tri = _traverse_raw(scene.triangles, stop_gradient(ray_o), stop_gradient(ray_d),
                               stop_gradient(t_max), any_hit=want_any)
        si = triangle_interaction_from_raw(
            scene.triangles, ray_o[:n_ext], ray_d[:n_ext], tri[:n_ext]
        )
        return si, tri[n_ext:] >= 0
    si_all = scene_intersect(scene, ray_o, ray_d, t_max, want_any=want_any)
    return _slice_si(si_all, 0, n_ext), si_all.valid[n_ext:]


def _slice_si(si, lo, hi):
    return type(si)(**{f.name: getattr(si, f.name)[lo:hi] for f in dataclasses.fields(si)
                       if getattr(si, f.name) is not None})


def scene_intersect_merged_full(scene: Scene, ray_o, ray_d, t_max, n_ext):
    """Merged trace where both halves need closest-hit interactions (a
    scene with interface media: the shadow march goes on past
    material-less boundaries, so a shadow lane needs its hit's material,
    media and normal, not an occlusion bit).  One traversal over all
    lanes, no any-hit lanes.  Returns (si_ext, si_shadow)."""
    si_all = scene_intersect(scene, ray_o, ray_d, t_max)
    return _slice_si(si_all, 0, n_ext), _slice_si(si_all, n_ext, ray_o.shape[0])


def _closer(a, b):
    """Per lane, ``b`` where it hits strictly closer than ``a`` (or ``a``
    misses), else ``a``."""
    take_b = b.valid & (~a.valid | (b.t < a.t))
    merged = {}
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if va is None:  # a footprint: set only after the trace
            merged[f.name] = None
            continue
        cond = take_b[..., None] if va.ndim > take_b.ndim else take_b
        merged[f.name] = torch.where(cond, vb, va)
    return type(a)(**merged)


def scene_intersect_predicate(scene: Scene, ray_o, ray_d, t_max):
    """Any-hit (shadow) test over every shape."""
    hit = torch.zeros(ray_o.shape[:-1], dtype=torch.bool, device=ray_o.device)
    if scene.has_spheres:
        hit = hit | sphere_intersect(scene.spheres, ray_o, ray_d, t_max).valid
    if scene.has_triangles:
        hit = hit | triangle_scene_occluded(scene.triangles, ray_o, ray_d, t_max)
    if scene.has_patches:
        hit = hit | bilinear_occluded(scene.patches, ray_o, ray_d, t_max)
    if scene.has_instanced:
        hit = hit | instanced_occluded(scene.instanced, ray_o, ray_d, t_max)
    return hit


def sample_light(scene: Scene, u):
    """Importance-sample the light table: (light_idx, pmf, u_remapped)."""
    w = torch.broadcast_to(scene.light_sample_weights, u.shape + (scene.n_lights,))
    return sample_discrete(w, u)


def light_pmf(scene: Scene, light_idx):
    total = torch.sum(scene.light_sample_weights)
    return scene.light_sample_weights[light_idx.long()] / total
