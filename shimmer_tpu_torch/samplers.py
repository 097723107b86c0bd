"""Samplers: per-lane random number streams (port of
``shimmer_tpu/samplers.py``: ``SamplerState``, ``IndependentSampler``,
``ZSobolSampler``, ``StratifiedSampler`` and ``create_sampler``).

A sampler is a pure function of (pixel, sample index, dimension), so the
port needs no ``torch.Generator``.  uint32 words live in int64 tensors
with values in [0, 2^32) (see ``ops/rng.py``); every stream is bit-exact
against the reference.

Every draw runs inside a ``sampler/draw`` span and every pixel sample's
start inside ``sampler/start`` (``utils/stats``); ``get_pixel_2d`` is
``get_2d``'s draw.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from shimmer_tpu_torch.ops import rng as srng
from shimmer_tpu_torch.ops.rng import MASK32, mul32
from shimmer_tpu_torch.ops.vecmath import vec2
from shimmer_tpu_torch.utils import stats


@dataclasses.dataclass(frozen=True)
class SamplerState:
    pixel_hash: torch.Tensor    # (...,) uint32 word in int64: morton index
    sample_index: torch.Tensor  # (...,) uint32 word in int64
    dim: torch.Tensor           # (...,) uint32 word in int64: next dimension

    def advance(self, k: int) -> "SamplerState":
        return dataclasses.replace(self, dim=(self.dim + k) & MASK32)


def _hashed_pixel_start(pixel_xy, sample_index, seed: int, dim0: int) -> SamplerState:
    """The pixel's seeded hash, the sample index and the first dimension."""
    px = srng.u32(pixel_xy[..., 0])
    py = srng.u32(pixel_xy[..., 1])
    ph = srng.hash_combine(px, py, seed)
    si = srng.u32(sample_index, device=ph.device) * torch.ones_like(ph)
    return SamplerState(pixel_hash=ph, sample_index=si, dim=torch.full_like(ph, dim0))


class IndependentSampler:
    """Counter-hash uniform sampler: every draw is pcg3d of (pixel hash,
    sample index, dimension)."""

    def __init__(self, samples_per_pixel: int, seed: int = 0):
        self.samples_per_pixel = int(samples_per_pixel)
        self.seed = int(seed)

    @stats.span("sampler/start")
    def start_pixel_sample(self, pixel_xy, sample_index, dim0: int = 0) -> SamplerState:
        return _hashed_pixel_start(pixel_xy, sample_index, self.seed, dim0)

    @stats.span("sampler/draw")
    def get_1d(self, state: SamplerState):
        u = srng.uniform_1d(state.pixel_hash, state.sample_index, state.dim)
        return u, state.advance(1)

    @stats.span("sampler/draw")
    def get_2d(self, state: SamplerState):
        ux, uy = srng.uniform_2d(state.pixel_hash, state.sample_index, state.dim)
        return vec2(ux, uy), state.advance(2)

    def get_pixel_2d(self, state: SamplerState):
        return self.get_2d(state)


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

    @stats.span("sampler/start")
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

    @stats.span("sampler/draw")
    def get_1d(self, state: SamplerState):
        idx = self._sample_index(state)
        h = srng.hash_combine(state.dim, self.seed)
        v = fast_owen_scramble(sobol_sample_u32(idx, 0, self._index_bits), h)
        return srng.u32_to_unit_float(v), state.advance(1)

    @stats.span("sampler/draw")
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


class StratifiedSampler:
    """Jittered stratified sampler: each dimension draws the stratum
    (sample index + a hash of the pixel and dimension) mod spp, jittered
    inside it by the independent draw (or centred without jitter).  spp is
    x_samples * y_samples."""

    def __init__(self, x_samples: int, y_samples: int, jitter: bool = True, seed: int = 0):
        self.x_samples = int(x_samples)
        self.y_samples = int(y_samples)
        self.samples_per_pixel = self.x_samples * self.y_samples
        self.jitter = bool(jitter)
        self.seed = int(seed)

    @stats.span("sampler/start")
    def start_pixel_sample(self, pixel_xy, sample_index, dim0: int = 0) -> SamplerState:
        return _hashed_pixel_start(pixel_xy, sample_index, self.seed, dim0)

    def _stratum(self, state):
        """Per-dimension shuffled stratum; the uint32 sum wraps before the
        modulo, as the reference's does."""
        h = srng.hash_combine(state.pixel_hash, state.dim)
        return srng.add32(state.sample_index, h) % self.samples_per_pixel

    @stats.span("sampler/draw")
    def get_1d(self, state: SamplerState):
        s = self._stratum(state)
        jit = (srng.uniform_1d(state.pixel_hash, state.sample_index, state.dim)
               if self.jitter else 0.5)
        return (s.to(torch.float32) + jit) / self.samples_per_pixel, state.advance(1)

    @stats.span("sampler/draw")
    def get_2d(self, state: SamplerState):
        s = self._stratum(state)
        x = s % self.x_samples
        y = s // self.x_samples
        if self.jitter:
            jx, jy = srng.uniform_2d(state.pixel_hash, state.sample_index, state.dim)
        else:
            jx = jy = 0.5
        u = vec2((x.to(torch.float32) + jx) / self.x_samples,
                 (y.to(torch.float32) + jy) / self.y_samples)
        return u, state.advance(2)

    def get_pixel_2d(self, state: SamplerState):
        return self.get_2d(state)


def create_sampler(name: str, samples_per_pixel: int, resolution=(1280, 720), seed: int = 0):
    """A sampler by its scene-file name; stratified takes the largest
    square-root grid that spp allows."""
    name = name.lower()
    if name == "independent":
        return IndependentSampler(samples_per_pixel, seed)
    if name in ("zsobol", "sobol", "paddedsobol"):
        return ZSobolSampler(samples_per_pixel, resolution, seed)
    if name == "stratified":
        n = int(np.sqrt(samples_per_pixel))
        return StratifiedSampler(n, max(1, samples_per_pixel // n), True, seed)
    raise ValueError(f"unknown sampler: {name}")
