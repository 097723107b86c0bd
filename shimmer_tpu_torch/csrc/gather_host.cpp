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

// The gather-sum in the form `counted` (1) or direct (0), in the kernels'
// order: each warp's chunks (sum_warp_col), the warps of a block in order,
// the blocks' partials in order.  The counted form counts the indices
// first, as counted_sum_kernel does.  N must be below 2^24 when counted.
extern "C" int shimmer_row_gather_sum_form_host(const float* table, int n_rows,
                                                int width, const int* idx, int n,
                                                int counted, float* out) {
  if (n_rows <= 0 || width <= 0 || width % 4 != 0 || width > kSumMaxWidth ||
      n < 0 || (counted != 0 && counted != 1) || (counted && n > kSumCountedMaxN)) {
    return -1;
  }
  std::vector<int> counts(counted ? n_rows : 0, 0);
  for (int i = 0; counted && i < n; ++i) {
    if (in_range(idx[i], n_rows)) ++counts[idx[i]];
  }
  const int items = counted ? n_rows : n;
  const int blocks = sum_blocks(items);
  for (int col = 0; col < width; ++col) {
    float total = 0.0f;
    for (int b = 0; b < blocks; ++b) {
      float block = 0.0f;
      for (int w = 0; w < kSumWarps; ++w) {
        const float s = sum_warp_col(counted != 0, table, n_rows, width, idx,
                                     counts.data(), items, blocks, b, w, col);
        block = w == 0 ? s : block + s;
      }
      total = b == 0 ? block : total + block;
    }
    out[col] = total;
  }
  return 0;
}

// The gather-sum in the form the card takes for (R, N, W).
extern "C" int shimmer_row_gather_sum_host(const float* table, int n_rows,
                                           int width, const int* idx, int n,
                                           float* out) {
  return shimmer_row_gather_sum_form_host(
      table, n_rows, width, idx, n,
      n >= 0 && gather_sum_counted(n_rows, n, width) ? 1 : 0, out);
}

extern "C" int shimmer_gather_sum_counted_host(int n_rows, int n, int width) {
  return gather_sum_counted(n_rows, n, width) ? 1 : 0;
}

// The one-column sum as col_sum_kernel adds it: each thread's values, the
// shuffle-down tree of each warp (lane l takes lane l + offset's value,
// offsets 16 .. 1), the warps in order, the blocks in order, times
// float(repeats).
extern "C" int shimmer_row_gather_col_sum_host(const float* table, int n_rows,
                                               int width, const int* idx, int n,
                                               int col, int repeats, float* out) {
  if (n_rows <= 0 || width <= 0 || n < 0 || col < 0 || col >= width ||
      repeats < 0 || repeats > kColSumMaxRepeats) {
    return -1;
  }
  constexpr int kWarp = 32;
  const int blocks = col_sum_blocks(n);
  const int threads = blocks * kColSumThreads;
  float total = 0.0f;
  for (int b = 0; b < blocks; ++b) {
    float block = 0.0f;
    for (int w = 0; w < kColSumThreads / kWarp; ++w) {
      float lane[kWarp];
      for (int l = 0; l < kWarp; ++l) {
        lane[l] = col_sum_thread(table, n_rows, width, idx, n, col,
                                 b * kColSumThreads + w * kWarp + l, threads);
      }
      for (int off = kWarp / 2; off > 0; off /= 2) {
        for (int l = 0; l + off < kWarp; ++l) lane[l] = lane[l] + lane[l + off];
      }
      block = w == 0 ? lane[0] : block + lane[0];
    }
    total = b == 0 ? block : total + block;
  }
  *out = static_cast<float>(repeats) * total;
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

// The staged chase's pass: the R + 1 pairs (next index, row sum) as
// chase_pairs_kernel writes them; pairs (n_rows + 1, 2) int32.
extern "C" int shimmer_chase_pairs_host(int dtype, const void* table, int n_rows,
                                        int width, int* pairs) {
  if (n_rows <= 0 || width < kChaseCols || width % 8 != 0 ||
      (dtype != 0 && dtype != 1)) {
    return -1;
  }
  ChasePair* out = reinterpret_cast<ChasePair*>(pairs);
  for (int r = 0; r <= n_rows; ++r) {
    out[r] = dtype == 0
                 ? chase_pair(static_cast<const float*>(table), n_rows, width, r)
                 : chase_pair(static_cast<const uint16_t*>(table), n_rows, width, r);
  }
  return 0;
}

// The staged chase as the card runs it where chase_staged holds (the pass,
// then the walk over `blocks` blocks of walk_threads(n) threads: each
// block's chunks of lanes in turn), for any n, steps and R.
extern "C" int shimmer_row_chase_staged_host(int dtype, const void* table,
                                             int n_rows, int width, const int* idx,
                                             int n, int steps, int blocks, float* out) {
  if (n < 0 || steps < 0 || blocks < 1) return -1;
  std::vector<int> pairs(2 * (static_cast<size_t>(n_rows) + 1));
  if (shimmer_chase_pairs_host(dtype, table, n_rows, width, pairs.data()) != 0) return -1;
  const ChasePair* p = reinterpret_cast<const ChasePair*>(pairs.data());
  for (int b = 0; b < blocks; ++b) {
    for (int c = b; c < walk_chunks(n); c += blocks) {
      for (int t = 0; t < walk_threads(n); ++t) {
        chase_walk_chunk(p, n_rows, idx, n, steps, c, t, out);
      }
    }
  }
  return 0;
}

extern "C" int shimmer_row_chase_staged(int n_rows, int n, int steps) {
  return chase_staged(n_rows, n, steps) ? 1 : 0;
}

extern "C" int shimmer_chase_stage_max_lanes() { return kChaseStageMaxLanes; }

extern "C" int shimmer_chase_stage_max_rows() { return kChaseStageMaxRows; }

extern "C" int shimmer_chase_stage_min_steps() { return kChaseStageMinSteps; }

extern "C" int shimmer_chase_wide_min_steps() { return kChaseWideMinSteps; }

extern "C" int shimmer_chase_many_lanes() { return kChaseManyLanes; }

extern "C" int shimmer_chase_many_lanes_min_steps() { return kChaseManyLanesMinSteps; }

extern "C" int shimmer_chase_walk_threads(int n) { return walk_threads(n); }

extern "C" int shimmer_gather_sum_rows_per_warp() { return kSumRowsPerWarp; }

extern "C" int shimmer_gather_sum_warps() { return kSumWarps; }

extern "C" int shimmer_gather_sum_max_width() { return kSumMaxWidth; }

extern "C" int shimmer_gather_sum_max_blocks() { return kSumMaxBlocks; }

extern "C" int shimmer_gather_sum_counted_max_n() { return kSumCountedMaxN; }

extern "C" int shimmer_gather_sum_counted_indices_per_row() { return kSumCountedIndicesPerRow; }

extern "C" int shimmer_gather_sum_counted_min_rows() { return kSumCountedMinRows; }

extern "C" int shimmer_gather_sum_counted_min_width() { return kSumCountedMinWidth; }

extern "C" int shimmer_col_sum_threads() { return kColSumThreads; }

extern "C" int shimmer_col_sum_max_blocks() { return kColSumMaxBlocks; }

extern "C" int shimmer_col_sum_max_repeats() { return kColSumMaxRepeats; }

extern "C" int shimmer_gather_cols_stage_max_rows() { return kStageMaxRows; }
