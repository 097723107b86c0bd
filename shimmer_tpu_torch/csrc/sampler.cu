// ZSobol sampler kernels for Hopper (sm_90a): a pixel sample's start and
// its draws, one launch a call of samplers.py::ZSobolSampler on CUDA
// tensors.
//
// They replace no Pallas kernel.  The reference's ZSobolSampler
// (shimmer_tpu/samplers.py) is plain jnp code, which XLA fuses into the
// surrounding computation on the TPU.  Run eagerly by torch, the same
// uint32 arithmetic is hundreds of int64 launches a draw (every word in an
// int64 carrier, every multiply split into 16-bit halves, the base-4
// digits hashed over [N, digits] tensors, the Sobol' product an [N, bits]
// term tensor xored in a loop): ~340 for a get_1d and ~490 for a get_2d,
// most of the diffuse render's device time and launches.
//
//   zsobol_start  pixel (x, y) and sample index -> the Morton word
//                 (Morton code << log2_spp | sample index), the sample
//                 index and the first dimension, each in an int64 carrier;
//   zsobol_draw<W>  (Morton word, dim) -> W floats (get_1d: W = 1, get_2d
//                 and get_pixel_2d: W = 2) and the advanced dim (dim + W),
//                 so the state's advance launches nothing more.
//
// What bounds them on the H100: integer operations.  A draw reads 16 bytes
// a lane and writes 12 or 16; its arithmetic is ~700-900 uint32 operations
// a lane at 1280x720 and 16 spp (13 base-4 digits, each hashed with three
// pcg rounds, then 26 Sobol' columns and the Owen scramble per dimension),
// ~25x the time its bytes take at 3.35 TB/s.  So each lane is one thread
// doing its whole draw in registers: the digit permutations are three
// 64-bit immediates (sampler_body.cuh, permute_digit), not a table read at
// a per-lane index, and the two Sobol' columns sit in __constant__ memory,
// where every lane of a warp reads the same column at the same step (one
// broadcast).  Loads and stores are one word a lane, coalesced; a get_2d
// writes its pair as one 8-byte store.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
// (ops/cuda_build.py).  Each entry point launches on `stream`, does not
// synchronise, allocates nothing, and returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments the kernels do not take.

#include <cuda_runtime.h>

#include "sampler_body.cuh"

namespace {

using namespace shimmer::sampler;

constexpr int kThreads = 256;
// Most blocks of a launch; larger calls loop over the grid (grid-stride).
constexpr int64_t kMaxBlocks = 1 << 16;

__constant__ uint32_t c_sobol_cols[2][32] = SHIMMER_SOBOL_COLS;

int blocks_for(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

__device__ __forceinline__ int64_t first_lane() {
  return static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ int64_t lane_stride() {
  return static_cast<int64_t>(gridDim.x) * blockDim.x;
}

// Lane i's pixel is (pixel_xy[2i], pixel_xy[2i + 1]); its sample index
// si[i * si_stride], or si_value where si is null (each word taken mod 2^32,
// as ops/rng.py::u32 does).
__global__ void __launch_bounds__(kThreads)
    zsobol_start_kernel(const int32_t* __restrict__ pixel_xy, const int64_t* __restrict__ si,
                        int64_t si_stride, uint32_t si_value, int64_t n, int log2_spp,
                        uint32_t dim0, int64_t* __restrict__ morton_out,
                        int64_t* __restrict__ si_out, int64_t* __restrict__ dim_out) {
  for (int64_t i = first_lane(); i < n; i += lane_stride()) {
    const uint32_t x = static_cast<uint32_t>(pixel_xy[2 * i]);
    const uint32_t y = static_cast<uint32_t>(pixel_xy[2 * i + 1]);
    const uint32_t s = si != nullptr ? static_cast<uint32_t>(si[i * si_stride]) : si_value;
    morton_out[i] = start_morton(x, y, s, log2_spp);
    si_out[i] = s;
    dim_out[i] = dim0;
  }
}

template <int kWidth>
__global__ void __launch_bounds__(kThreads)
    zsobol_draw_kernel(const int64_t* __restrict__ morton, const int64_t* __restrict__ dim,
                       int64_t n, ZSobolParams p, float* __restrict__ u,
                       int64_t* __restrict__ dim_out) {
  for (int64_t i = first_lane(); i < n; i += lane_stride()) {
    const uint32_t d = static_cast<uint32_t>(dim[i]);
    float out[2];
    zsobol_draw<kWidth>(static_cast<uint32_t>(morton[i]), d, p, c_sobol_cols, out);
    if constexpr (kWidth == 1) {
      u[i] = out[0];
    } else {
      reinterpret_cast<float2*>(u)[i] = make_float2(out[0], out[1]);
    }
    dim_out[i] = static_cast<uint32_t>(d + kWidth);
  }
}

int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

}  // namespace

// pixel_xy: n (x, y) int32 pairs.  sample_index: null (every lane
// si_value), or n (si_stride 1) or one (si_stride 0) int64 words.  Out:
// three int64 arrays of n.
extern "C" int shimmer_zsobol_start(const int32_t* pixel_xy, const int64_t* sample_index,
                                    int64_t si_stride, uint32_t si_value, int64_t n,
                                    int log2_spp, uint32_t dim0, int64_t* morton,
                                    int64_t* si_out, int64_t* dim_out, void* stream) {
  if (n < 0 || (si_stride != 0 && si_stride != 1) || log2_spp < 0 || log2_spp >= 32) {
    return invalid();
  }
  if (n > 0) {
    zsobol_start_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        pixel_xy, sample_index, si_stride, si_value, n, log2_spp, dim0, morton, si_out, dim_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// morton, dim: n int64 carriers.  u: n floats (width 1) or n pairs (width
// 2, 8-byte aligned); dim_out: n int64.
extern "C" int shimmer_zsobol_draw(const int64_t* morton, const int64_t* dim, int64_t n,
                                   uint32_t seed, int log2_spp, int n_base4_digits,
                                   int index_bits, int width, float* u, int64_t* dim_out,
                                   void* stream) {
  if (n < 0 || (width != 1 && width != 2) || log2_spp < 0 || log2_spp >= 32 ||
      n_base4_digits < 1 || n_base4_digits > 64 || index_bits < 0 || index_bits > 32) {
    return invalid();
  }
  if (n > 0) {
    const ZSobolParams p{seed, log2_spp, n_base4_digits, index_bits};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (width == 1) {
      zsobol_draw_kernel<1><<<blocks_for(n), kThreads, 0, s>>>(morton, dim, n, p, u, dim_out);
    } else {
      zsobol_draw_kernel<2><<<blocks_for(n), kThreads, 0, s>>>(morton, dim, n, p, u, dim_out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
