"""Samplers: per-lane random number streams (port of
``shimmer_tpu/samplers.py``: ``SamplerState`` and ``ZSobolSampler``).

A sampler is a pure function of (pixel, sample index, dimension), so the
port needs no ``torch.Generator``.  uint32 words live in int64 tensors
with values in [0, 2^32) (see ``ops/rng.py``); every stream is bit-exact
against the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from shimmer_tpu_torch.ops import rng as srng
from shimmer_tpu_torch.ops.rng import MASK32, mul32
from shimmer_tpu_torch.ops.vecmath import vec2


@dataclasses.dataclass(frozen=True)
class SamplerState:
    pixel_hash: torch.Tensor    # (...,) uint32 word in int64: morton index
    sample_index: torch.Tensor  # (...,) uint32 word in int64
    dim: torch.Tensor           # (...,) uint32 word in int64: next dimension

    def advance(self, k: int) -> "SamplerState":
        return dataclasses.replace(self, dim=(self.dim + k) & MASK32)


def _sobol_cols() -> np.ndarray:
    """Generator-matrix column masks of the first two Sobol' dimensions."""
    cols = np.zeros((2, 32), np.int64)
    for j in range(32):
        cols[0, j] = 1 << (31 - j)
    m = [1, 3]
    for j in range(2, 32):
        m.append((2 * m[j - 1]) ^ (4 * m[j - 2]) ^ m[j - 2])
    for j in range(32):
        cols[1, j] = (m[j] << (31 - j)) & MASK32
    return cols


_SOBOL_COLS = _sobol_cols()

_PERMUTATIONS = np.array(
    [
        [0, 1, 2, 3], [0, 1, 3, 2], [0, 2, 1, 3], [0, 2, 3, 1],
        [0, 3, 2, 1], [0, 3, 1, 2], [1, 0, 2, 3], [1, 0, 3, 2],
        [1, 2, 0, 3], [1, 2, 3, 0], [1, 3, 2, 0], [1, 3, 0, 2],
        [2, 1, 0, 3], [2, 1, 3, 0], [2, 0, 1, 3], [2, 0, 3, 1],
        [2, 3, 0, 1], [2, 3, 1, 0], [3, 1, 2, 0], [3, 1, 0, 2],
        [3, 2, 1, 0], [3, 2, 0, 1], [3, 0, 2, 1], [3, 0, 1, 2],
    ],
    np.int64,
)


def sobol_sample_u32(index, dim: int, bits: int):
    """Sobol' generator matrix ``dim`` times the uint32 ``index``."""
    cols = torch.as_tensor(_SOBOL_COLS[dim, :bits], device=index.device)
    shifts = torch.arange(bits, dtype=torch.int64, device=index.device)
    on = ((index[..., None] >> shifts) & 1) != 0
    terms = torch.where(on, cols, 0)
    out = torch.zeros_like(index)
    for k in range(bits):
        out = out ^ terms[..., k]
    return out


def _reverse_bits32(v):
    v = ((v >> 1) & 0x55555555) | ((v & 0x55555555) << 1)
    v = ((v >> 2) & 0x33333333) | ((v & 0x33333333) << 2)
    v = ((v >> 4) & 0x0F0F0F0F) | ((v & 0x0F0F0F0F) << 4)
    v = ((v >> 8) & 0x00FF00FF) | ((v & 0x00FF00FF) << 8)
    return ((v >> 16) | (v << 16)) & MASK32


def fast_owen_scramble(v, seed):
    """Laine-Karras style hash-based Owen scrambling."""
    v = _reverse_bits32(v)
    v = v ^ mul32(v, 0x3D20ADEA)
    v = (v + seed) & MASK32
    v = mul32(v, (seed >> 16) | 1)
    v = v ^ mul32(v, 0x05526C56)
    v = v ^ mul32(v, 0x53A22864)
    return _reverse_bits32(v)


def _encode_morton2(x, y):
    def spread(v):
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        v = (v | (v << 1)) & 0x55555555
        return v

    return ((spread(y) << 1) | spread(x)) & MASK32


class ZSobolSampler:
    """Z-order (Morton) scrambled Sobol' sampler (pbrt-v4 ZSobolSampler)."""

    def __init__(self, samples_per_pixel: int, resolution, seed: int = 0):
        spp = int(samples_per_pixel)
        self.samples_per_pixel = spp
        self.seed = int(seed)
        self.log2_spp = max(0, (spp - 1).bit_length())
        res = int(max(resolution))
        log4_spp = (self.log2_spp + 1) // 2
        self.n_base4_digits = max(1, (res - 1).bit_length()) + log4_spp
        self._index_bits = min(32, 2 * self.n_base4_digits)

    def start_pixel_sample(self, pixel_xy, sample_index, dim0: int = 0) -> SamplerState:
        px = srng.u32(pixel_xy[..., 0])
        py = srng.u32(pixel_xy[..., 1])
        si = srng.u32(sample_index, device=px.device) * torch.ones_like(px)
        morton = ((_encode_morton2(px, py) << self.log2_spp) & MASK32) | si
        return SamplerState(
            pixel_hash=morton, sample_index=si, dim=torch.full_like(px, dim0)
        )

    def _sample_index(self, state: SamplerState):
        """Randomized Morton index (pbrt ZSobolSampler::GetSampleIndex)."""
        morton = state.pixel_hash
        dim = state.dim
        pow2_samples = (self.log2_spp & 1) == 1
        last_digit = 1 if pow2_samples else 0
        i_vals = np.arange(self.n_base4_digits - 1, last_digit - 1, -1)
        shifts = torch.as_tensor(
            2 * i_vals - (1 if pow2_samples else 0), dtype=torch.int64,
            device=morton.device,
        )
        m = morton[..., None]
        digit = (m >> shifts) & 3
        higher = m >> (shifts + 2)
        h = srng.hash_combine(higher, dim[..., None], self.seed)
        p = ((h >> 16) * 24) >> 16
        perm = torch.as_tensor(_PERMUTATIONS, device=morton.device)
        dig = perm[p, digit]
        sample_index = torch.zeros_like(morton)
        for k in range(dig.shape[-1]):
            sample_index = sample_index | ((dig[..., k] << shifts[k]) & MASK32)
        if pow2_samples:
            digit0 = morton & 1
            sample_index = sample_index | (
                digit0 ^ (srng.hash_combine(morton >> 1, dim, self.seed) & 1)
            )
        return sample_index

    def get_1d(self, state: SamplerState):
        idx = self._sample_index(state)
        h = srng.hash_combine(state.dim, self.seed)
        v = fast_owen_scramble(sobol_sample_u32(idx, 0, self._index_bits), h)
        return srng.u32_to_unit_float(v), state.advance(1)

    def get_2d(self, state: SamplerState):
        idx = self._sample_index(state)
        h = srng.hash_combine(state.dim, self.seed)
        vx = fast_owen_scramble(sobol_sample_u32(idx, 0, self._index_bits), h)
        vy = fast_owen_scramble(
            sobol_sample_u32(idx, 1, self._index_bits), h ^ 0x55555555
        )
        u = vec2(srng.u32_to_unit_float(vx), srng.u32_to_unit_float(vy))
        return u, state.advance(2)

    def get_pixel_2d(self, state: SamplerState):
        return self.get_2d(state)
