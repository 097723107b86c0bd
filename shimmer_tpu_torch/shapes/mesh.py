"""Host triangle meshes (port of ``shimmer_tpu/shapes/mesh.py``:
``TriangleMesh`` and ``quad_mesh``; PLY reading waits for the loader)."""

from __future__ import annotations

import numpy as np

from shimmer_tpu_torch.ops.transform import Transform


class TriangleMesh:
    """Host-side mesh with vertices pre-transformed to render space."""

    def __init__(
        self,
        render_from_object: Transform,
        indices,
        p,
        n=None,
        uv=None,
        reverse_orientation: bool = False,
    ):
        self.indices = np.asarray(indices, np.int32).reshape(-1, 3)
        p = np.asarray(p, np.float32)
        m = np.asarray(render_from_object.m, np.float64)
        ph = p @ m[:3, :3].T + m[:3, 3]
        ww = p @ m[3:4, :3].T + m[3, 3]
        self.p = (ph / np.where(ww == 0.0, 1.0, ww)).astype(np.float32)
        if n is not None:
            mi = np.asarray(render_from_object.m_inv, np.float64)
            n_r = np.asarray(n, np.float32) @ mi[:3, :3]
            norm = np.linalg.norm(n_r, axis=-1, keepdims=True)
            self.n = (n_r / np.maximum(norm, 1e-12)).astype(np.float32)
            if bool(render_from_object.swaps_handedness()):
                self.n = -self.n
        else:
            self.n = None
        self.uv = np.asarray(uv, np.float32) if uv is not None else None
        self.reverse_orientation = bool(reverse_orientation)

    @property
    def n_triangles(self):
        return self.indices.shape[0]

    def as_scene_dict(self, material_id=-1, area_light_id=-1) -> dict:
        return {
            "p": self.p,
            "indices": self.indices,
            "n": self.n,
            "uv": self.uv,
            "material_id": material_id,
            "area_light_id": area_light_id,
            "reverse_orientation": self.reverse_orientation,
        }


def quad_mesh(render_from_object: Transform, p00, p10, p11, p01, **kw) -> TriangleMesh:
    """Two-triangle quad."""
    p = np.stack([p00, p10, p11, p01]).astype(np.float32)
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return TriangleMesh(render_from_object, idx, p, uv=uv, **kw)
