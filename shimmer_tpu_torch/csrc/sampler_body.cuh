// ZSobol sampler (pbrt-v4's ZSobolSampler): the per-lane uint32 arithmetic
// of samplers.py::ZSobolSampler and ops/rng.py, shared by the CUDA kernels
// (sampler.cu) and a host build (sampler_host.cpp) that the CPU tests
// compile with g++: under nvcc the functions are __host__ __device__, under
// g++ plain inline.
//
// The torch version holds each uint32 word in an int64 tensor and splits
// every multiply into 16-bit halves; here a word is a uint32_t, so a
// multiply wraps mod 2^32 as the reference's does.  One rule keeps the two
// equal where the int64 carrier shifts by 32 or more (the digits above the
// top one, once 2 x n_base4_digits reaches 32, as at 65536x65536): such a
// shift gives 0 (shl32 / shr32), where C++ leaves it undefined.  Every function is bit
// for bit the torch version's; nothing is skipped or approximated.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define SHIMMER_SAMPLER_HD __host__ __device__ __forceinline__
#else
#define SHIMMER_SAMPLER_HD inline
#endif

// The generator-matrix columns of the first two Sobol' dimensions
// (samplers.py::_sobol_cols), [dimension][bit]: the initializer of the
// kernels' __constant__ table and of the host build's.
#define SHIMMER_SOBOL_COLS                                                     \
  {                                                                            \
    {                                                                          \
      0x80000000u, 0x40000000u, 0x20000000u, 0x10000000u, 0x08000000u,         \
      0x04000000u, 0x02000000u, 0x01000000u, 0x00800000u, 0x00400000u,         \
      0x00200000u, 0x00100000u, 0x00080000u, 0x00040000u, 0x00020000u,         \
      0x00010000u, 0x00008000u, 0x00004000u, 0x00002000u, 0x00001000u,         \
      0x00000800u, 0x00000400u, 0x00000200u, 0x00000100u, 0x00000080u,         \
      0x00000040u, 0x00000020u, 0x00000010u, 0x00000008u, 0x00000004u,         \
      0x00000002u, 0x00000001u                                                 \
    },                                                                         \
    {                                                                          \
      0x80000000u, 0xC0000000u, 0x60000000u, 0x90000000u, 0xE8000000u,         \
      0x5C000000u, 0x8E000000u, 0xC5000000u, 0x68800000u, 0x9CC00000u,         \
      0xEE600000u, 0x55900000u, 0x80680000u, 0xC09C0000u, 0x60EE0000u,         \
      0x90550000u, 0xE8808000u, 0x5CC0C000u, 0x8E606000u, 0xC5909000u,         \
      0x6868E800u, 0x9C9C5C00u, 0xEEEE8E00u, 0x5555C500u, 0x8000E880u,         \
      0xC0005CC0u, 0x60008E60u, 0x9000C590u, 0xE8006868u, 0x5C009C9Cu,         \
      0x8E00EEEEu, 0xC5005555u                                                 \
    }                                                                          \
  }

namespace shimmer {
namespace sampler {

// pbrt's ONE_MINUS_EPSILON (config.py): the largest float32 below 1.
constexpr float kOneMinusEpsilon = 0x1.fffffep-1f;
// hash_combine's starting word.
constexpr uint32_t kHashInit = 0x9E3779B9u;
// The 24 permutations of the four base-4 digits (samplers.py::_PERMUTATIONS),
// one byte each (2 bits a digit, digit d at bits 2d), eight to a word: the
// permuted digit is found in registers, with no table to index by lane.
constexpr uint64_t kPerm0 = 0xB1E19C6C78D8B4E4ull;  // permutations 0-7
constexpr uint64_t kPerm1 = 0x72D236C68D2D39C9ull;  // 8-15
constexpr uint64_t kPerm2 = 0x93634B1B87271E4Eull;  // 16-23

// x << s and x >> s for any s >= 0, 0 from s = 32 on (the int64 carrier's
// result once masked to 32 bits).
SHIMMER_SAMPLER_HD uint32_t shl32(uint32_t x, int s) { return s < 32 ? x << s : 0u; }
SHIMMER_SAMPLER_HD uint32_t shr32(uint32_t x, int s) { return s < 32 ? x >> s : 0u; }

// ops/rng.py::pcg_hash.
SHIMMER_SAMPLER_HD uint32_t pcg_hash(uint32_t x) {
  const uint32_t state = x * 747796405u + 2891336453u;
  const uint32_t word = ((state >> ((state >> 28) + 4u)) ^ state) * 277803737u;
  return (word >> 22) ^ word;
}

// ops/rng.py::hash_combine of two and of three words.
SHIMMER_SAMPLER_HD uint32_t hash_combine(uint32_t a, uint32_t b) {
  return pcg_hash(b ^ pcg_hash(a ^ kHashInit));
}

SHIMMER_SAMPLER_HD uint32_t hash_combine(uint32_t a, uint32_t b, uint32_t c) {
  return pcg_hash(c ^ hash_combine(a, b));
}

// samplers.py::_encode_morton2.
SHIMMER_SAMPLER_HD uint32_t spread_bits(uint32_t v) {
  v = (v | (v << 8)) & 0x00FF00FFu;
  v = (v | (v << 4)) & 0x0F0F0F0Fu;
  v = (v | (v << 2)) & 0x33333333u;
  v = (v | (v << 1)) & 0x55555555u;
  return v;
}

SHIMMER_SAMPLER_HD uint32_t encode_morton2(uint32_t x, uint32_t y) {
  return (spread_bits(y) << 1) | spread_bits(x);
}

// ZSobolSampler.start_pixel_sample's Morton word: the pixel's Morton code
// above log2_spp bits, or'ed with the sample index.
SHIMMER_SAMPLER_HD uint32_t start_morton(uint32_t x, uint32_t y, uint32_t sample_index,
                                         int log2_spp) {
  return shl32(encode_morton2(x, y), log2_spp) | sample_index;
}

// Digit `digit` (0-3) under permutation `p` (0-23).
SHIMMER_SAMPLER_HD uint32_t permute_digit(uint32_t p, uint32_t digit) {
  const uint64_t word = p < 8u ? kPerm0 : (p < 16u ? kPerm1 : kPerm2);
  const uint32_t code = static_cast<uint32_t>(word >> ((p & 7u) * 8u));
  return (code >> (2u * digit)) & 3u;
}

// ZSobolSampler._sample_index (pbrt's GetSampleIndex): each base-4 digit
// of the Morton word, from the top, permuted by a hash of the digits above
// it, the dimension and the seed; with an odd log2_spp the last digit is
// one bit, flipped by a hash.
SHIMMER_SAMPLER_HD uint32_t sample_index(uint32_t morton, uint32_t dim, uint32_t seed,
                                         int log2_spp, int n_base4_digits) {
  const int pow2 = log2_spp & 1;
  uint32_t index = 0;
  for (int i = n_base4_digits - 1; i >= pow2; --i) {
    const int shift = 2 * i - pow2;
    const uint32_t digit = shr32(morton, shift) & 3u;
    const uint32_t h = hash_combine(shr32(morton, shift + 2), dim, seed);
    const uint32_t p = ((h >> 16) * 24u) >> 16;
    index |= shl32(permute_digit(p, digit), shift);
  }
  if (pow2) index |= (morton & 1u) ^ (hash_combine(morton >> 1, dim, seed) & 1u);
  return index;
}

// samplers.py::sobol_sample_u32: the xor of the columns whose bit of
// `index` is set, over the first `bits` (<= 32) columns.
SHIMMER_SAMPLER_HD uint32_t sobol_sample(uint32_t index, const uint32_t* cols, int bits) {
  uint32_t out = 0;
  for (int k = 0; k < bits; ++k) out ^= cols[k] & (0u - ((index >> k) & 1u));
  return out;
}

// samplers.py::_reverse_bits32.
SHIMMER_SAMPLER_HD uint32_t reverse_bits(uint32_t v) {
#if defined(__CUDA_ARCH__)
  return __brev(v);
#else
  v = ((v >> 1) & 0x55555555u) | ((v & 0x55555555u) << 1);
  v = ((v >> 2) & 0x33333333u) | ((v & 0x33333333u) << 2);
  v = ((v >> 4) & 0x0F0F0F0Fu) | ((v & 0x0F0F0F0Fu) << 4);
  v = ((v >> 8) & 0x00FF00FFu) | ((v & 0x00FF00FFu) << 8);
  return (v >> 16) | (v << 16);
#endif
}

// samplers.py::fast_owen_scramble.
SHIMMER_SAMPLER_HD uint32_t fast_owen_scramble(uint32_t v, uint32_t seed) {
  v = reverse_bits(v);
  v ^= v * 0x3D20ADEAu;
  v += seed;
  v *= (seed >> 16) | 1u;
  v ^= v * 0x05526C56u;
  v ^= v * 0x53A22864u;
  return reverse_bits(v);
}

// ops/rng.py::u32_to_unit_float: the top 24 bits over 2^24 (exact), at most
// kOneMinusEpsilon.
SHIMMER_SAMPLER_HD float u32_to_unit_float(uint32_t u) {
  const float f = static_cast<float>(u >> 8) * 0x1p-24f;
  return f < kOneMinusEpsilon ? f : kOneMinusEpsilon;
}

// A ZSobolSampler's fields, as the draw reads them.
struct ZSobolParams {
  uint32_t seed;       // the sampler's seed, mod 2^32
  int log2_spp;
  int n_base4_digits;
  int index_bits;      // min(32, 2 * n_base4_digits)
};

// ZSobolSampler.get_1d (kWidth 1) and get_2d (kWidth 2) of the lane at
// (morton, dim): out[0 .. kWidth).  cols: SHIMMER_SOBOL_COLS.
template <int kWidth>
SHIMMER_SAMPLER_HD void zsobol_draw(uint32_t morton, uint32_t dim, const ZSobolParams& p,
                                    const uint32_t (*cols)[32], float* out) {
  const uint32_t idx = sample_index(morton, dim, p.seed, p.log2_spp, p.n_base4_digits);
  const uint32_t h = hash_combine(dim, p.seed);
  out[0] = u32_to_unit_float(fast_owen_scramble(sobol_sample(idx, cols[0], p.index_bits), h));
  if constexpr (kWidth == 2) {
    out[1] = u32_to_unit_float(
        fast_owen_scramble(sobol_sample(idx, cols[1], p.index_bits), h ^ 0x55555555u));
  }
}

}  // namespace sampler
}  // namespace shimmer
