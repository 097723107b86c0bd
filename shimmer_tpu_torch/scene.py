"""Device scene: flat tables plus the static census (port of
``shimmer_tpu/scene.py``, triangles-only).

The census (which material, light and shape kinds exist) is plain Python
attributes that pick code paths, as the reference's static fields do
under jit.
"""

from __future__ import annotations

import dataclasses

import torch

from shimmer_tpu_torch.lights.lights import LightData
from shimmer_tpu_torch.materials.material import MaterialTable
from shimmer_tpu_torch.ops.sampling import sample_discrete
from shimmer_tpu_torch.shapes.triangle import (
    TriangleSceneData,
    _traverse_raw,
    triangle_interaction_from_raw,
)


@dataclasses.dataclass(frozen=True)
class Scene:
    triangles: TriangleSceneData
    materials: MaterialTable
    lights: LightData
    light_sample_weights: torch.Tensor  # (L,) pmf weights
    # --- static census ---
    material_kinds: tuple = ()
    light_kinds: tuple = ()
    n_lights: int = 0
    uniform_infinite_indices: tuple = ()

    @property
    def device(self):
        return self.triangles.rows8.device

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


def scene_intersect_merged(scene: Scene, ray_o, ray_d, t_max, n_ext):
    """Wavefront merged trace: lanes [:n_ext] are extension rays
    (closest hit, full interaction), lanes [n_ext:] are shadow rays (any
    hit, occlusion only).  One raw traversal over all lanes; interactions
    are built for the extension slice only.  Returns (si_ext, occluded)."""
    n_all = ray_o.shape[0]
    want_any = torch.arange(n_all, device=ray_o.device) >= n_ext
    _, tri = _traverse_raw(scene.triangles, ray_o, ray_d, t_max, any_hit=want_any)
    si = triangle_interaction_from_raw(
        scene.triangles, ray_o[:n_ext], ray_d[:n_ext], tri[:n_ext]
    )
    return si, tri[n_ext:] >= 0


def sample_light(scene: Scene, u):
    """Importance-sample the light table: (light_idx, pmf, u_remapped)."""
    w = torch.broadcast_to(scene.light_sample_weights, u.shape + (scene.n_lights,))
    return sample_discrete(w, u)


def light_pmf(scene: Scene, light_idx):
    total = torch.sum(scene.light_sample_weights)
    return scene.light_sample_weights[light_idx.long()] / total
