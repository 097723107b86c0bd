// Test-only host build of the gather kernels' bodies (gather_body.cuh).
//
// The CPU tests compile this file with g++ (-ffp-contract=off) and call it
// through ctypes, so the kernels' own per-lane logic and summation order
// are checked against the plain torch versions (ops/gather.py) on a
// machine without a GPU.  No entry point of the port loads it.  Arguments
// as gather.cu's entry points, less the stream; each returns 0, or -1 for
// arguments the kernels do not take.

#include <algorithm>
#include <vector>

#include "gather_body.cuh"

using namespace shimmer::gather;

extern "C" int shimmer_row_gather_host(const float* table, int n_rows,
                                       int width, const int* idx, int n,
                                       float* out) {
  if (n_rows <= 0 || width <= 0 || width % 4 != 0 || n < 0) return -1;
  for (int i = 0; i < n; ++i) {
    gather_row_part(table, n_rows, width, idx[i],
                    out + static_cast<size_t>(i) * width, 0, 1);
  }
  return 0;
}

// The kernel's two forms, chosen by R as the kernel chooses: the staged
// one per (column pair, chunk of outputs) from a copy of the columns, the
// direct one element by element.
extern "C" int shimmer_row_gather_cols_host(const float* table_t, int n_rows,
                                            int width, const int* idx, int n,
                                            float* out) {
  if (n_rows <= 0 || width <= 0 || n < 0) return -1;
  if (n_rows <= kStageMaxRows) {
    std::vector<float> cols(static_cast<size_t>(kStageCols) * n_rows);
    for (int col0 = 0; col0 < width; col0 += kStageCols) {
      const int n_cols = width - col0 < kStageCols ? width - col0 : kStageCols;
      for (int begin = 0; begin < n; begin += kStageChunk) {
        std::copy(table_t + static_cast<size_t>(col0) * n_rows,
                  table_t + static_cast<size_t>(col0 + n_cols) * n_rows,
                  cols.begin());
        const int end = begin + kStageChunk < n ? begin + kStageChunk : n;
        for (int i = begin; i < end; ++i) {
          gather_staged_elem(cols.data(), n_rows, width, idx[i], out, n, i,
                             col0);
        }
      }
    }
    return 0;
  }
  for (int col = 0; col < width; ++col) {
    for (int i = 0; i < n; ++i) {
      out[static_cast<size_t>(col) * n + i] = gather_col_elem(
          table_t + static_cast<size_t>(col) * n_rows, n_rows, idx[i]);
    }
  }
  return 0;
}

// The kernel's order within each block (chunks left to right, chunk sums
// in warp order); the blocks' sums are added in block order, one of the
// orders the kernel's atomics can take.
extern "C" int shimmer_row_gather_sum_host(const float* table, int n_rows,
                                           int width, const int* idx, int n,
                                           float* out) {
  if (n_rows <= 0 || width <= 0 || width % 4 != 0 || width > kSumMaxWidth ||
      n < 0) {
    return -1;
  }
  for (int col = 0; col < width; ++col) {
    float total = 0.0f;
    for (int b = 0; b < sum_blocks(n); ++b) {
      float block = 0.0f;
      for (int w = 0; w < kSumWarps; ++w) {
        const int chunk = b * kSumWarps + w;
        const float s = sum_chunk_col(table, n_rows, width, idx,
                                      chunk_begin(chunk, n),
                                      chunk_end(chunk, n), col);
        block = w == 0 ? s : block + s;
      }
      total = total + block;
    }
    out[col] = total;
  }
  return 0;
}

extern "C" int shimmer_row_chase_host(int dtype, const void* table,
                                      int n_rows, int width, const int* idx,
                                      int n, int steps, float* out) {
  if (n_rows <= 0 || width < kChaseCols || width % 8 != 0 || n < 0 ||
      steps < 0 || (dtype != 0 && dtype != 1)) {
    return -1;
  }
  for (int i = 0; i < n; ++i) {
    out[i] = dtype == 0
                 ? chase_lane(static_cast<const float*>(table), n_rows, width,
                              idx[i], steps)
                 : chase_lane(static_cast<const uint16_t*>(table), n_rows,
                              width, idx[i], steps);
  }
  return 0;
}

extern "C" int shimmer_gather_sum_rows_per_warp() { return kSumRowsPerWarp; }

extern "C" int shimmer_gather_sum_warps() { return kSumWarps; }

extern "C" int shimmer_gather_sum_max_width() { return kSumMaxWidth; }

extern "C" int shimmer_gather_cols_stage_max_rows() { return kStageMaxRows; }
