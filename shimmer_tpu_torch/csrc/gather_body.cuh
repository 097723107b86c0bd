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
//   gather-sum  out[:] = sum_i T[idx[i], :]   (and one column of it,
//                                             repeats * sum_i T[idx[i], col])
//   chase       per lane, K dependent steps from idx[i]:
//                 row = T[idx]; acc += row[1] + ... + row[8]; idx = int(row[0])
//               (read from the table a step, or, where chase_staged
//               says so, from each row's (next index, row sum) staged in
//               shared memory)
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

// What a chase step takes from a row: the next index (n_rows, an index
// that reads zeros, where next_index gives one out of range) and the row
// sum row[1] + ... + row[8], added left to right.
struct alignas(8) ChasePair {
  int next;
  float sum;
};

SHIMMER_GATHER_HD ChasePair chase_pair_of(const float v[kChaseCols],
                                          int n_rows) {
  float s = v[1];
  for (int j = 2; j < kChaseCols; ++j) s = s + v[j];
  const int next = next_index(v[0], n_rows);
  return ChasePair{in_range(next, n_rows) ? next : n_rows, s};
}

// The pair of index r, or of the row of zeros that an index outside
// [0, R) reads (sum +0, next index 0).
template <typename T>
SHIMMER_GATHER_HD ChasePair chase_pair(const T* table, int n_rows, int width,
                                       int r) {
  float v[kChaseCols];
  if (in_range(r, n_rows)) {
    load_chase_cols(table + static_cast<size_t>(r) * width, v);
  } else {
    for (int j = 0; j < kChaseCols; ++j) v[j] = 0.0f;
  }
  return chase_pair_of(v, n_rows);
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

// The staged chase: a pass writes the pair of every row and, at index R,
// the pair of the row of zeros (chase_pair(table, R, W, R)); the walk
// stages the R + 1 pairs in each block's shared memory, and each step of a
// lane is one dependent 8-byte shared load and one add.  The sums are the
// ones chase_lane adds, in the same order, so the two are bit-equal.
SHIMMER_GATHER_HD float chase_walk_lane(const ChasePair* pairs, int n_rows,
                                        int idx, int steps) {
  int r = in_range(idx, n_rows) ? idx : n_rows;
  float acc = 0.0f;
  for (int k = 0; k < steps; ++k) {
    const ChasePair p = pairs[r];
    acc = acc + p.sum;
    r = p.next;
  }
  return acc;
}

// The walk's partition of the lanes: chunks of `threads` consecutive
// lanes (walk_threads), chunk c to block c % blocks (a block stages the
// pairs once and takes chunks c, c + blocks, ...), lane t of a chunk to
// thread t.  Blocks of kWalkThreads threads for many lanes, where the card
// is full either way; blocks of kWalkFewThreads for at most
// kWalkFewLanes lanes, which spread them over twice as many SMs (measured
// faster there and slower for many lanes: PERF.md).
constexpr int kWalkThreads = 1024;
constexpr int kWalkFewThreads = 512;
constexpr int kWalkFewLanes = 16384;

SHIMMER_GATHER_HD int walk_threads(int n) {
  return n <= kWalkFewLanes ? kWalkFewThreads : kWalkThreads;
}

SHIMMER_GATHER_HD int walk_chunks(int n) {
  return static_cast<int>((static_cast<long long>(n) + walk_threads(n) - 1) / walk_threads(n));
}

SHIMMER_GATHER_HD void chase_walk_chunk(const ChasePair* pairs, int n_rows,
                                        const int* idx, int n, int steps,
                                        int chunk, int thread, float* out) {
  const long long lane = static_cast<long long>(chunk) * walk_threads(n) + thread;
  if (lane >= n) return;
#if defined(__CUDA_ARCH__)
  const int x = __ldg(idx + lane);
#else
  const int x = idx[lane];
#endif
  out[lane] = chase_walk_lane(pairs, n_rows, x, steps);
}

// The dispatch between the two forms, a function of (R, N, K) alone, set
// by timing every chase case of the reference scripts in both forms
// (PERF.md).  The staged form builds R + 1 pairs (8 bytes each, within the
// 227 KB of shared memory a block may take: R <= kChaseStageMaxRows) and
// stages them in every block of the walk, a fixed cost of two launches and
// the staging; it pays where the chains are long or many:
//   * at most kChaseStageMaxLanes lanes (6E): at least kChaseStageMinSteps
//     steps and R / 64 (the pass reads every row once);
//   * more lanes: at least kChaseWideMinSteps steps (every K = 32 case,
//     N from 1,024 to 524,288), or at least kChaseManyLanes lanes with at
//     least kChaseManyLanesMinSteps steps (the K = 8 bf16 chase at N =
//     131,072; at N = 8,192 its per-lane form is faster).
// The rest keep chase_lane, one thread a lane.
constexpr int kChaseStageMaxLanes = 32;
constexpr int kChaseStageMinSteps = 256;
constexpr int kChaseStageMaxRows =
    static_cast<int>(227 * 1024 / sizeof(ChasePair)) - 1;
constexpr int kChaseWideMinSteps = 32;
constexpr int kChaseManyLanes = 131072;
constexpr int kChaseManyLanesMinSteps = 8;

SHIMMER_GATHER_HD bool chase_staged(int n_rows, int n, int steps) {
  if (n < 1 || n_rows > kChaseStageMaxRows) return false;
  if (n <= kChaseStageMaxLanes) {
    return steps >= kChaseStageMinSteps && steps >= n_rows / 64;
  }
  return steps >= kChaseWideMinSteps ||
         (n >= kChaseManyLanes && steps >= kChaseManyLanesMinSteps);
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

// The gather-sum, out[c] = sum_i T[idx[i], c], W <= kSumMaxWidth (one
// float4 per lane of a warp), in two forms over one partition:
//   * direct: item i is row idx[i] with weight 1 (0, skipped, where the
//     index is outside [0, R));
//   * counted: a pass counts the indices per row (integer adds, exact in
//     any order), then item r is row r with weight count[r] (skipped where
//     0), so each distinct row is read once however often it occurs.
// The items are cut into chunks of kSumRowsPerWarp consecutive items (a
// warp's rows in flight); chunk c goes to warp slot c % (blocks *
// kSumWarps) of block slot / kSumWarps, and each warp adds its chunks'
// items in item order, acc = acc + float(weight) * row (the product and
// the add rounded apart: the kernels build with -fmad=false, the host with
// -ffp-contract=off), from 0.  A block adds its warps' sums in warp order
// into its partial, and the last block to finish (by a ticket) adds the
// partials in block order.  No float atomics: the order is a function of
// (R, N, W) alone, the same on every run and in the host build.
constexpr int kSumMaxWidth = 128;
constexpr int kSumWarps = 32;
constexpr int kSumRowsPerWarp = 8;
constexpr int kSumMaxBlocks = 128;
// float(count) is exact only below 2^24, and a count is at most N.
constexpr int kSumCountedMaxN = (1 << 24) - 1;
// The rule between the forms (gather_sum_counted), set by timing both on
// the card over R in {2,048 .. 2^20}, N in {1,024 .. 524,288}, W in {8,
// 128} (PERF.md): counted where the indices repeat each row at least
// kSumCountedIndicesPerRow times on average, over at least
// kSumCountedMinRows rows (fewer rows share their counts among too many
// atomics), with rows of kSumCountedMinWidth floats (a narrow row costs no
// more to read again than its count); direct elsewhere.  The counted grid,
// sum_blocks(R) <= kSumMaxBlocks blocks of 1,024 threads, is resident at
// once on an H100 SXM (132 SMs), as its cooperative launch requires.
constexpr int kSumCountedIndicesPerRow = 4;
constexpr int kSumCountedMinRows = 16384;
constexpr int kSumCountedMinWidth = 128;

SHIMMER_GATHER_HD bool gather_sum_counted(int n_rows, int n, int width) {
  return n <= kSumCountedMaxN && n_rows >= kSumCountedMinRows &&
         width >= kSumCountedMinWidth &&
         static_cast<long long>(n) >= static_cast<long long>(kSumCountedIndicesPerRow) * n_rows;
}

SHIMMER_GATHER_HD int sum_chunks(int items) {
  return static_cast<int>((static_cast<long long>(items) + kSumRowsPerWarp - 1) /
                          kSumRowsPerWarp);
}

// Blocks of a sum over `items` items: one warp a chunk up to kSumMaxBlocks
// blocks (then the warps take chunks in turn), and at least one block, which
// writes zeros for no items.
SHIMMER_GATHER_HD int sum_blocks(int items) {
  const int b = (sum_chunks(items) + kSumWarps - 1) / kSumWarps;
  return b < 1 ? 1 : (b > kSumMaxBlocks ? kSumMaxBlocks : b);
}

// Item i < items of a sum: its row and weight (0: the item adds nothing).
SHIMMER_GATHER_HD int sum_item_row(bool counted, const int* idx, int i) {
#if defined(__CUDA_ARCH__)
  return counted ? i : __ldg(idx + i);
#else
  return counted ? i : idx[i];
#endif
}

// The counts are written by the same launch (atomics, in L2): the device
// reads them there, past the non-coherent L1.
SHIMMER_GATHER_HD int sum_item_weight(bool counted, const int* counts, int row,
                                      int n_rows) {
  if (counted) {
#if defined(__CUDA_ARCH__)
    return __ldcg(counts + row);
#else
    return counts[row];
#endif
  }
  return in_range(row, n_rows) ? 1 : 0;
}

SHIMMER_GATHER_HD float sum_weighted(float acc, int weight, float v) {
  const float w = static_cast<float>(weight);
  const float p = w * v;
  return acc + p;
}

// Warp `warp` of block `block` (of `blocks`): its sum of column `col`
// over its chunks in order, as the kernel's lane holding `col` adds it.
SHIMMER_GATHER_HD float sum_warp_col(bool counted, const float* table, int n_rows,
                                     int width, const int* idx, const int* counts,
                                     int items, int blocks, int block, int warp,
                                     int col) {
  float acc = 0.0f;
  for (int c = block * kSumWarps + warp; c < sum_chunks(items); c += blocks * kSumWarps) {
    for (int j = 0; j < kSumRowsPerWarp; ++j) {
      const int i = c * kSumRowsPerWarp + j;
      if (i >= items) break;
      const int row = sum_item_row(counted, idx, i);
      const int weight = sum_item_weight(counted, counts, row, n_rows);
      if (weight != 0) {
        acc = sum_weighted(acc, weight, table[static_cast<size_t>(row) * width + col]);
      }
    }
  }
  return acc;
}

// The one-column sum (6D), repeats * sum_i T[idx[i], col]: thread t of
// block b (kColSumThreads threads, col_sum_blocks(n) blocks) adds the
// values of items t + b * kColSumThreads + k * stride, k = 0, 1, ... in
// order, from 0 (an index outside [0, R) adds 0); a warp reduces its
// threads' sums by a shuffle-down tree (offsets 16, 8, 4, 2, 1; lane 0
// keeps the sum), a block adds its warps' sums in warp order, and the
// last block to finish (by a ticket) adds the partials in block order and
// multiplies by float(repeats).
constexpr int kColSumThreads = 256;
constexpr int kColSumMaxBlocks = 128;
// repeats converts to float exactly.
constexpr int kColSumMaxRepeats = 1 << 24;

SHIMMER_GATHER_HD int col_sum_blocks(int n) {
  const long long b = (static_cast<long long>(n) + kColSumThreads - 1) / kColSumThreads;
  return b < 1 ? 1 : (b > kColSumMaxBlocks ? kColSumMaxBlocks : static_cast<int>(b));
}

SHIMMER_GATHER_HD float col_value(const float* table, int n_rows, int width,
                                  int idx, int col) {
  if (!in_range(idx, n_rows)) return 0.0f;
#if defined(__CUDA_ARCH__)
  return __ldg(table + static_cast<size_t>(idx) * width + col);
#else
  return table[static_cast<size_t>(idx) * width + col];
#endif
}

// Thread `thread` of the one-column sum's grid (`threads` = blocks *
// kColSumThreads): its values in order.
SHIMMER_GATHER_HD float col_sum_thread(const float* table, int n_rows, int width,
                                       const int* idx, int n, int col, int thread,
                                       int threads) {
  float s = 0.0f;
  for (long long i = thread; i < n; i += threads) {
#if defined(__CUDA_ARCH__)
    const int r = __ldg(idx + i);
#else
    const int r = idx[i];
#endif
    s = s + col_value(table, n_rows, width, r, col);
  }
  return s;
}

}  // namespace gather
}  // namespace shimmer
