// Row gathers from a (R, W) table by int32 index: the per-lane bodies and
// the summation orders of the gather kernels.  Shared by the CUDA kernels
// (gather.cu) and a host build (gather_host.cpp) that the CPU tests compile
// with g++: under nvcc the functions are __host__ __device__, under g++
// plain inline, and the loads go through the read-only path (__ldg) only
// on the device.
//
// Three functions, as in the reference's gather experiments
// (experiments/pallas_gather.py, pallas_gather2.py, exp_pallas_gather.py,
// exp_pallas_gather2.py):
//   gather      out[i, :] = T[idx[i], :]     (and the transposed layout,
//                                             out[:, i] = Tt[:, idx[i]])
//   gather-sum  out[:] = sum_i T[idx[i], :]
//   chase       per lane, K dependent steps from idx[i]:
//                 row = T[idx]; acc += row[1] + ... + row[8]; idx = int(row[0])
// One rule for every index: an index outside [0, R) reads a row of zeros,
// so a chase that meets one goes on from index 0.  This is what the
// reference's one-hot product (pallas_gather.py:149-156) does with an
// index that bf16 rounding pushed to R, and it keeps every kernel inside
// its table whatever the indices hold.
//
// All arithmetic is float32 additions in a fixed order (the chase adds
// row[1..8] left to right and then adds that to acc), so the kernels, this
// host build and the plain torch versions (ops/gather.py) agree bit for bit
// where the order is the same.
#pragma once

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#if defined(__CUDACC__)
#define SHIMMER_GATHER_HD __host__ __device__ __forceinline__
#else
#define SHIMMER_GATHER_HD inline
#endif

namespace shimmer {
namespace gather {

// Columns a chase step reads: row[0] (the next index) and row[1..8].
constexpr int kChaseCols = 9;
// The gather-sum's partition of the indices: each warp sums
// kSumRowsPerWarp consecutive indices, kSumWarps warps to a block; its
// widest row is kSumMaxWidth floats (one float4 per lane of a warp).
constexpr int kSumRowsPerWarp = 64;
constexpr int kSumWarps = 8;
constexpr int kSumMaxWidth = 128;

// 16-byte aligned, so that a store of one is a single 16-byte store.
struct alignas(16) Float4 {
  float x, y, z, w;
};

SHIMMER_GATHER_HD bool in_range(int idx, int n_rows) {
  return idx >= 0 && idx < n_rows;
}

// The next index from a row's column 0: truncation toward zero, as
// astype(int32) does, for every value in (-1, R); -1 (out of range) for
// NaN and everything else, where truncation would be undefined or land
// outside the table anyway.
SHIMMER_GATHER_HD int next_index(float x0, int n_rows) {
  return (x0 > -1.0f && x0 < static_cast<float>(n_rows)) ? static_cast<int>(x0)
                                                         : -1;
}

// bf16 storage is the high 16 bits of a float32: widening is exact.
SHIMMER_GATHER_HD float bf16_bits_to_float(uint16_t b) {
  const uint32_t u = static_cast<uint32_t>(b) << 16;
#if defined(__CUDA_ARCH__)
  return __uint_as_float(u);
#else
  float f;
  memcpy(&f, &u, sizeof(f));
  return f;
#endif
}

// Loads of the chase's nine columns of one row.  On the device: two
// 16-byte read-only loads and one 4-byte load for a float32 row (36 bytes,
// two 32-byte sectors), one 16-byte and one 2-byte load for a bf16 row
// (18 bytes, one sector).  Rows must be 16-byte aligned (the wrapper
// checks the table's address and W).
SHIMMER_GATHER_HD void load_chase_cols(const float* row, float v[kChaseCols]) {
#if defined(__CUDA_ARCH__)
  const float4 a = __ldg(reinterpret_cast<const float4*>(row));
  const float4 b = __ldg(reinterpret_cast<const float4*>(row) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  v[8] = __ldg(row + 8);
#else
  for (int j = 0; j < kChaseCols; ++j) v[j] = row[j];
#endif
}

SHIMMER_GATHER_HD void load_chase_cols(const uint16_t* row,
                                       float v[kChaseCols]) {
#if defined(__CUDA_ARCH__)
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(row));
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = __uint_as_float(w[j] << 16);          // element 2j (low half)
    v[2 * j + 1] = __uint_as_float(w[j] & 0xFFFF0000u);  // element 2j + 1
  }
  v[8] = bf16_bits_to_float(__ldg(row + 8));
#else
  for (int j = 0; j < kChaseCols; ++j) v[j] = bf16_bits_to_float(row[j]);
#endif
}

// One lane of the chase: `steps` dependent row reads from `idx`, each
// adding row[1..8] (left to right) to the accumulator.  T is float
// (float32 rows) or uint16_t (bf16 rows, the bits of __nv_bfloat16).
template <typename T>
SHIMMER_GATHER_HD float chase_lane(const T* table, int n_rows, int width,
                                   int idx, int steps) {
  float acc = 0.0f;
  for (int k = 0; k < steps; ++k) {
    float v[kChaseCols];
    if (in_range(idx, n_rows)) {
      load_chase_cols(table + static_cast<size_t>(idx) * width, v);
    } else {
      for (int j = 0; j < kChaseCols; ++j) v[j] = 0.0f;
    }
    float s = v[1];
    for (int j = 2; j < kChaseCols; ++j) s = s + v[j];
    acc = acc + s;
    idx = next_index(v[0], n_rows);
  }
  return acc;
}

SHIMMER_GATHER_HD Float4 load4(const float* p) {
#if defined(__CUDA_ARCH__)
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  return Float4{a.x, a.y, a.z, a.w};
#else
  return Float4{p[0], p[1], p[2], p[3]};
#endif
}

// Columns [4c, 4c + 4) of out_row = T[idx] for c = part, part + parts, ...
// over the W / 4 groups of a row (a warp: part = lane, parts = 32; the
// host: 0 and 1).  W is a multiple of 4 and rows are 16-byte aligned.
SHIMMER_GATHER_HD void gather_row_part(const float* table, int n_rows,
                                       int width, int idx, float* out_row,
                                       int part, int parts) {
  const bool ok = in_range(idx, n_rows);
  const float* src = table + (ok ? static_cast<size_t>(idx) * width : 0);
  Float4* dst = reinterpret_cast<Float4*>(out_row);
  for (int c = part; 4 * c < width; c += parts) {
    dst[c] = ok ? load4(src + 4 * c) : Float4{0.0f, 0.0f, 0.0f, 0.0f};
  }
}

// The transposed gather, out[c * N + i] = Tt[c * R + idx[i]], in two
// forms.  Staged (R at most kStageMaxRows): a block copies kStageCols
// consecutive columns of the (W, R) table -- contiguous in memory -- into
// shared memory with coalesced reads, then gathers kStageChunk outputs
// from the copy.  Direct (larger R): one element per lane, read from the
// table (gather_col_elem).
constexpr int kStageCols = 2;
constexpr int kStageChunk = 2048;
constexpr int kStageMaxRows = 12288;  // kStageCols * R floats within 96 KB

// Output element i of the staged form's columns [col0, col0 + kStageCols)
// (those below W) from `cols`, their copy laid out back to back.
SHIMMER_GATHER_HD void gather_staged_elem(const float* cols, int n_rows,
                                          int width, int idx, float* out,
                                          int n, int i, int col0) {
  const bool ok = in_range(idx, n_rows);
#pragma unroll
  for (int j = 0; j < kStageCols; ++j) {
    if (col0 + j < width) {
      out[static_cast<size_t>(col0 + j) * n + i] =
          ok ? cols[static_cast<size_t>(j) * n_rows + idx] : 0.0f;
    }
  }
}

// One element of the direct form: Tt[col, idx] from the column-major row
// `table_t_col` (= Tt + col * R).
SHIMMER_GATHER_HD float gather_col_elem(const float* table_t_col, int n_rows,
                                        int idx) {
  if (!in_range(idx, n_rows)) return 0.0f;
#if defined(__CUDA_ARCH__)
  return __ldg(table_t_col + idx);
#else
  return table_t_col[idx];
#endif
}

// The gather-sum's summation order for column `col`: each warp's chunk of
// kSumRowsPerWarp indices is summed left to right from 0 (sum_chunk_col),
// a block adds its kSumWarps chunk sums in warp order, and
// the blocks' sums meet in `out` through one atomicAdd per column and
// block, in whatever order the blocks finish.  The host build adds the
// blocks in block order.
SHIMMER_GATHER_HD float sum_chunk_col(const float* table, int n_rows,
                                      int width, const int* idx, int begin,
                                      int end, int col) {
  float acc = 0.0f;
  for (int i = begin; i < end; ++i) {
    const int r = idx[i];
    acc = acc + (in_range(r, n_rows) ? table[static_cast<size_t>(r) * width + col]
                                     : 0.0f);
  }
  return acc;
}

SHIMMER_GATHER_HD int chunk_begin(int chunk, int n) {
  const long long b = static_cast<long long>(chunk) * kSumRowsPerWarp;
  return b < n ? static_cast<int>(b) : n;
}

SHIMMER_GATHER_HD int chunk_end(int chunk, int n) {
  const long long e = static_cast<long long>(chunk + 1) * kSumRowsPerWarp;
  return e < n ? static_cast<int>(e) : n;
}

SHIMMER_GATHER_HD int sum_blocks(int n) {
  const int rows_per_block = kSumRowsPerWarp * kSumWarps;
  return (n + rows_per_block - 1) / rows_per_block;
}

}  // namespace gather
}  // namespace shimmer
