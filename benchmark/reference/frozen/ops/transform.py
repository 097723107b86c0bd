"""4x4 transforms with cached inverses (port of
``shimmer_tpu/ops/transform.py``).

Constructors and composition run in numpy on the host, exactly as in the
reference; the application methods take torch tensors of shape (..., 3)
and run on their device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _np3(x):
    return np.asarray(x, np.float64).reshape(3)


@dataclasses.dataclass(frozen=True)
class Transform:
    m: np.ndarray      # (4, 4) float32
    m_inv: np.ndarray  # (4, 4) float32

    @staticmethod
    def identity():
        eye = np.eye(4, dtype=np.float32)
        return Transform(m=eye, m_inv=eye)

    @staticmethod
    def from_matrix(m):
        """A float64 matrix and its float64 inverse, each rounded once to
        float32."""
        m = np.asarray(m, np.float64)
        return Transform(m=m.astype(np.float32), m_inv=np.linalg.inv(m).astype(np.float32))

    @staticmethod
    def translate(delta):
        delta = _np3(delta)
        m = np.eye(4, dtype=np.float32)
        m[0:3, 3] = delta
        mi = np.eye(4, dtype=np.float32)
        mi[0:3, 3] = -delta
        return Transform(m=m, m_inv=mi)

    @staticmethod
    def scale(sx, sy, sz):
        s = np.array([float(sx), float(sy), float(sz), 1.0], np.float32)
        return Transform(m=np.diag(s), m_inv=np.diag((1.0 / s).astype(np.float32)))

    @staticmethod
    def look_at(pos, look, up):
        """Camera-to-world transform."""
        pos, look, up = _np3(pos), _np3(look), _np3(up)
        dir_ = look - pos
        dir_ = dir_ / np.linalg.norm(dir_)
        upn = up / np.linalg.norm(up)
        right = np.cross(upn, dir_)
        right = right / np.linalg.norm(right)
        new_up = np.cross(dir_, right)
        c2w = np.stack(
            [
                np.append(right, 0.0),
                np.append(new_up, 0.0),
                np.append(dir_, 0.0),
                np.append(pos, 1.0),
            ],
            axis=-1,
        )
        return Transform(
            m=c2w.astype(np.float32), m_inv=np.linalg.inv(c2w).astype(np.float32)
        )

    @staticmethod
    def orthographic(z_near, z_far):
        z_near, z_far = float(z_near), float(z_far)
        m = np.eye(4, dtype=np.float64)
        m[2, 2] = 1.0 / (z_far - z_near)
        m[2, 3] = -z_near / (z_far - z_near)
        return Transform(m=m.astype(np.float32), m_inv=np.linalg.inv(m).astype(np.float32))

    @staticmethod
    def perspective(fov_deg, n, f):
        n, f = float(n), float(f)
        persp = np.array(
            [
                [1.0, 0.0, 0.0, 0.0],
                [0.0, 1.0, 0.0, 0.0],
                [0.0, 0.0, f / (f - n), -f * n / (f - n)],
                [0.0, 0.0, 1.0, 0.0],
            ],
            np.float64,
        )
        inv_tan = 1.0 / np.tan(np.deg2rad(float(fov_deg)) / 2.0)
        m = np.diag([inv_tan, inv_tan, 1.0, 1.0]) @ persp
        return Transform(
            m=m.astype(np.float32), m_inv=np.linalg.inv(m).astype(np.float32)
        )

    def compose(self, other: "Transform") -> "Transform":
        """self o other: apply ``other`` first."""
        return Transform(m=self.m @ other.m, m_inv=other.m_inv @ self.m_inv)

    def __matmul__(self, other: "Transform") -> "Transform":
        return self.compose(other)

    def inverse(self) -> "Transform":
        return Transform(m=self.m_inv, m_inv=self.m)

    def apply_point(self, p):
        ph = _apply44(self.m, p, 1.0)
        w = ph[..., 3]
        xyz = ph[..., :3]
        return torch.where(
            (w == 1.0)[..., None],
            xyz,
            xyz / torch.where(w == 0.0, torch.ones_like(w), w)[..., None],
        )

    def apply_vector(self, v):
        return _apply44(self.m, v, 0.0)[..., :3]

    def swaps_handedness(self):
        return np.linalg.det(np.asarray(self.m)[..., :3, :3]) < 0.0


def _apply44(m, v, w):
    """[v, w] times the rows of a host (4, 4) matrix, over batched (..., 3)
    v, with the sum spelled out so every device adds in the same order."""
    m = torch.as_tensor(np.asarray(m, np.float32), device=v.device)
    rows = [
        v[..., 0] * m[i, 0] + v[..., 1] * m[i, 1] + v[..., 2] * m[i, 2] + w * m[i, 3]
        for i in range(4)
    ]
    return torch.stack(rows, dim=-1)
