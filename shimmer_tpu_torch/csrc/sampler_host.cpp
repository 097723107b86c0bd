// Test-only host build of the ZSobol kernels' bodies (sampler_body.cuh).
//
// The CPU tests compile this file with g++ and call it through ctypes, so
// the kernels' own per-lane arithmetic is checked against the torch
// version (samplers.py::ZSobolSampler) on a machine without a GPU.  No
// entry point of the port loads it.  Arguments as sampler.cu's entry
// points, less the stream; each returns 0, or -1 for arguments the kernels
// do not take.

#include "sampler_body.cuh"

using namespace shimmer::sampler;

namespace {

const uint32_t kSobolCols[2][32] = SHIMMER_SOBOL_COLS;

}  // namespace

extern "C" int shimmer_zsobol_start_host(const int32_t* pixel_xy, const int64_t* sample_index,
                                         int64_t si_stride, uint32_t si_value, int64_t n,
                                         int log2_spp, uint32_t dim0, int64_t* morton,
                                         int64_t* si_out, int64_t* dim_out) {
  if (n < 0 || (si_stride != 0 && si_stride != 1) || log2_spp < 0 || log2_spp >= 32) {
    return -1;
  }
  for (int64_t i = 0; i < n; ++i) {
    const uint32_t s = sample_index != nullptr
                           ? static_cast<uint32_t>(sample_index[i * si_stride])
                           : si_value;
    morton[i] = start_morton(static_cast<uint32_t>(pixel_xy[2 * i]),
                             static_cast<uint32_t>(pixel_xy[2 * i + 1]), s, log2_spp);
    si_out[i] = s;
    dim_out[i] = dim0;
  }
  return 0;
}

extern "C" int shimmer_zsobol_draw_host(const int64_t* morton, const int64_t* dim, int64_t n,
                                        uint32_t seed, int log2_spp, int n_base4_digits,
                                        int index_bits, int width, float* u,
                                        int64_t* dim_out) {
  if (n < 0 || (width != 1 && width != 2) || log2_spp < 0 || log2_spp >= 32 ||
      n_base4_digits < 1 || n_base4_digits > 64 || index_bits < 0 || index_bits > 32) {
    return -1;
  }
  const ZSobolParams p{seed, log2_spp, n_base4_digits, index_bits};
  for (int64_t i = 0; i < n; ++i) {
    const uint32_t d = static_cast<uint32_t>(dim[i]);
    if (width == 1) {
      zsobol_draw<1>(static_cast<uint32_t>(morton[i]), d, p, kSobolCols, u + i);
    } else {
      zsobol_draw<2>(static_cast<uint32_t>(morton[i]), d, p, kSobolCols, u + 2 * i);
    }
    dim_out[i] = static_cast<uint32_t>(d + width);
  }
  return 0;
}

// The table the kernels read: out[64], dimension-major.
extern "C" void shimmer_sobol_cols_host(uint32_t* out) {
  for (int d = 0; d < 2; ++d) {
    for (int k = 0; k < 32; ++k) out[32 * d + k] = kSobolCols[d][k];
  }
}

extern "C" uint32_t shimmer_permute_digit_host(uint32_t p, uint32_t digit) {
  return permute_digit(p, digit);
}
