// Row-gather kernels for Hopper (sm_90a): gather, gather-sum and the
// dependent row chase (float32 and bf16 rows).
//
// Replace the Pallas kernels of the reference's gather experiments, which
// measure how a TPU kernel reaches a 128-float row of a table by a per-lane
// index (kernel-table rows 6-9 in PERF.md):
//   row_gather        out[i, :] = T[idx[i], :]
//                     experiments/pallas_gather2.py:34 (check_and_bench_taa0,
//                     its single gather, kernel :43), exp_pallas_gather.py:51
//                     (make_take), :84 (make_scalar), exp_pallas_gather2.py:36
//                     (make_scalar), :101 (make_taa);
//   row_gather_cols   out[:, i] = Tt[:, idx[i]] on the transposed table
//                     pallas_gather2.py:108 (check_and_bench_taa1);
//   row_gather_sum    out[:] = sum_i T[idx[i], :]
//                     exp_pallas_gather2.py:74 (make_scalar_reduce), and
//                     pallas_gather.py:181 (bench_pallas_dma, whose value is
//                     4 * out[1]);
//   row_chase<T>      K dependent steps per lane, idx = int(row[0]),
//                     acc += row[1] + ... + row[8]
//                     T = float: pallas_gather.py:72 (bench_pallas_vmem_take),
//                     :106 (bench_pallas_vmem_take_cols), :232
//                     (bench_pallas_scalar_rows, one lane from index 0),
//                     pallas_gather2.py:34 (check_and_bench_taa0, its chase,
//                     kernel :73); T = bf16: pallas_gather.py:140
//                     (bench_pallas_onehot, the chase over T rounded to bf16).
// The TPU strategies (jnp.take in VMEM, column takes, a one-hot MXU
// product, per-row DMA, scalar dynamic slices, take_along_axis) are ways
// for Mosaic to reach a row; on Hopper they are one question, how a thread
// or a warp reads a 512-byte row, and each function is one kernel here.
//
// What bounds them on the H100, and what the designs do about it:
//   * gather: bytes.  The output (N x 512 B) dominates; one warp moves one
//     row, 16 bytes per lane, so each row is one coalesced 512-byte read
//     (from L2 for a table that fits its 50 MB) and one coalesced write.
//   * transposed gather: out[:, i] = Tt[:, idx[i]].  Read straight from
//     the table, every value costs a 32-byte sector of L2 traffic (the
//     indices are scattered): about 8x its bytes, ~32 MB at R = N = 8192,
//     W = 128, and that sector rate bounds it (and index_select; a thread
//     reading a group of columns with its index loaded once measured no
//     faster).  So a table whose two columns fit in 96 KB of shared memory
//     is staged: a block copies kStageCols consecutive columns of the
//     (W, R) table (contiguous, so fully used sectors) into shared memory,
//     then each thread loads an index once and gathers the pair from the
//     copy, for a chunk of kStageChunk outputs with stores coalesced along
//     i.  The table is read once per chunk (4 MB x 4 at that size) and idx
//     once per column pair; the grid is 4 x 64 blocks of 512 threads, ~2
//     per SM.  A larger table takes the direct form, one element a thread.
//   * gather-sum: bytes of the distinct rows read, and the latency of
//     reaching them, since the output is one row.  Each warp keeps 8 rows in
//     flight in a shared-memory ring filled by cp.async (16 bytes per lane,
//     zero-filled for an out-of-range index), the counterpart of the
//     reference's 8 in-flight row DMAs, and adds them in registers; blocks
//     combine with one atomicAdd per column (so the last bits of the sum
//     vary from run to run with the blocks' order).
//   * chase: neither bytes nor operations but the latency of K dependent
//     reads per lane (each step needs the last step's row to find the next
//     one).  One thread per lane reads only the 9 columns a step needs,
//     through the read-only path (36 bytes, two sectors, for float32 rows;
//     18 bytes, one sector, for bf16 rows), and the N lanes' chains overlap.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
// (ops/cuda_build.py).  Each entry point launches on `stream`, does not
// synchronise, allocates nothing, and returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments the kernels do not take.

#include <cuda_runtime.h>

#include "gather_body.cuh"

namespace {

using namespace shimmer::gather;

constexpr int kWarp = 32;
constexpr int kGatherWarps = 8;       // rows per block of row_gather
constexpr int kColsThreads = 256;     // output elements per block, direct cols form
constexpr int kStageThreads = 512;    // staged cols form
constexpr int kChaseThreads = 128;
constexpr int kRing = 8;              // rows in flight per warp, gather-sum

__global__ void __launch_bounds__(kGatherWarps * kWarp)
    row_gather_kernel(const float* __restrict__ table, int n_rows, int width,
                      const int* __restrict__ idx, int n,
                      float* __restrict__ out) {
  const int i = blockIdx.x * kGatherWarps + threadIdx.x / kWarp;
  if (i >= n) return;
  gather_row_part(table, n_rows, width, __ldg(idx + i),
                  out + static_cast<size_t>(i) * width, threadIdx.x % kWarp,
                  kWarp);
}

__global__ void __launch_bounds__(kStageThreads)
    row_gather_cols_staged_kernel(const float* __restrict__ table_t,
                                  int n_rows, int width,
                                  const int* __restrict__ idx, int n,
                                  float* __restrict__ out) {
  extern __shared__ float cols[];
  const int col0 = blockIdx.y * kStageCols;
  const int n_cols = min(kStageCols, width - col0);
  const float* src = table_t + static_cast<size_t>(col0) * n_rows;
  for (int k = threadIdx.x; k < n_cols * n_rows; k += kStageThreads) {
    cols[k] = __ldg(src + k);
  }
  __syncthreads();
  const int end = min(n, (blockIdx.x + 1) * kStageChunk);
  for (int i = blockIdx.x * kStageChunk + threadIdx.x; i < end;
       i += kStageThreads) {
    gather_staged_elem(cols, n_rows, width, __ldg(idx + i), out, n, i, col0);
  }
}

__global__ void __launch_bounds__(kColsThreads)
    row_gather_cols_kernel(const float* __restrict__ table_t, int n_rows,
                           const int* __restrict__ idx, int n,
                           float* __restrict__ out) {
  const int i = blockIdx.x * kColsThreads + threadIdx.x;
  if (i >= n) return;
  const int col = blockIdx.y;
  out[static_cast<size_t>(col) * n + i] = gather_col_elem(
      table_t + static_cast<size_t>(col) * n_rows, n_rows, __ldg(idx + i));
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool ok) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  // src-size 0 copies nothing and fills the 16 bytes with zeros.
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 1) : "memory");
}

__global__ void __launch_bounds__(kSumWarps * kWarp)
    row_gather_sum_kernel(const float* __restrict__ table, int n_rows,
                          int width, const int* __restrict__ idx, int n,
                          float* __restrict__ out) {
  __shared__ __align__(16) float ring[kSumWarps][kRing][kSumMaxWidth];
  __shared__ float part[kSumWarps][kSumMaxWidth];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int chunk = blockIdx.x * kSumWarps + warp;
  const int begin = chunk_begin(chunk, n);
  const int end = chunk_end(chunk, n);
  const int col = 4 * lane;  // this lane's columns: col .. col + 3
  const bool has_cols = col < width;

  // Row `i` of the chunk into ring slot `slot` (this lane's 16 bytes).
  auto issue = [&](int i, int slot) {
    if (has_cols && i < end) {
      const int r = __ldg(idx + i);
      const bool ok = in_range(r, n_rows);
      cp_async16(&ring[warp][slot][col],
                 table + (ok ? static_cast<size_t>(r) * width + col : 0), ok);
    }
    // One group per row, empty past the chunk's end, so that waiting
    // for all but kRing - 1 groups always means the oldest row landed.
    cp_async_commit();
  };

  for (int s = 0; s < kRing; ++s) issue(begin + s, s);
  Float4 acc{0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = begin; i < end; ++i) {
    const int slot = (i - begin) % kRing;
    cp_async_wait_ring();
    if (has_cols) {
      const float4 v = *reinterpret_cast<const float4*>(&ring[warp][slot][col]);
      acc.x = acc.x + v.x;
      acc.y = acc.y + v.y;
      acc.z = acc.z + v.z;
      acc.w = acc.w + v.w;
    }
    // The slot is read before the next copy into it is issued.
    __syncwarp();
    issue(i + kRing, slot);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (has_cols) {
    part[warp][col + 0] = acc.x;
    part[warp][col + 1] = acc.y;
    part[warp][col + 2] = acc.z;
    part[warp][col + 3] = acc.w;
  }
  __syncthreads();
  if (threadIdx.x < width) {
    float s = part[0][threadIdx.x];
    for (int w = 1; w < kSumWarps; ++w) s = s + part[w][threadIdx.x];
    atomicAdd(out + threadIdx.x, s);
  }
}

template <typename T>
__global__ void __launch_bounds__(kChaseThreads)
    row_chase_kernel(const T* __restrict__ table, int n_rows, int width,
                     const int* __restrict__ idx, int n, int steps,
                     float* __restrict__ out) {
  const int i = blockIdx.x * kChaseThreads + threadIdx.x;
  if (i >= n) return;
  out[i] = chase_lane(table, n_rows, width, __ldg(idx + i), steps);
}

int blocks_for(int n, int per_block) { return (n + per_block - 1) / per_block; }

int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

}  // namespace

// W a positive multiple of 4; out (n, W).
extern "C" int shimmer_row_gather(const float* table, int n_rows, int width,
                                  const int* idx, int n, float* out,
                                  void* stream) {
  if (n_rows <= 0 || width <= 0 || width % 4 != 0 || n < 0) return invalid();
  if (n > 0) {
    row_gather_kernel<<<blocks_for(n, kGatherWarps), kGatherWarps * kWarp, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        table, n_rows, width, idx, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// table_t (W, R), out (W, n).
extern "C" int shimmer_row_gather_cols(const float* table_t, int n_rows,
                                       int width, const int* idx, int n,
                                       float* out, void* stream) {
  if (n_rows <= 0 || width <= 0 || width > 65535 || n < 0) return invalid();
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_rows <= kStageMaxRows) {
    const size_t smem = sizeof(float) * kStageCols * n_rows;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          row_gather_cols_staged_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const dim3 grid(blocks_for(n, kStageChunk), blocks_for(width, kStageCols));
    row_gather_cols_staged_kernel<<<grid, kStageThreads, smem, s>>>(
        table_t, n_rows, width, idx, n, out);
  } else {
    const dim3 grid(blocks_for(n, kColsThreads), width);
    row_gather_cols_kernel<<<grid, kColsThreads, 0, s>>>(table_t, n_rows, idx,
                                                        n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// W a positive multiple of 4, at most kSumMaxWidth; out (W,) is zeroed
// here (on the stream) and then accumulated into.
extern "C" int shimmer_row_gather_sum(const float* table, int n_rows,
                                      int width, const int* idx, int n,
                                      float* out, void* stream) {
  if (n_rows <= 0 || width <= 0 || width % 4 != 0 || width > kSumMaxWidth ||
      n < 0) {
    return invalid();
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float) * width, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    row_gather_sum_kernel<<<sum_blocks(n), kSumWarps * kWarp, 0, s>>>(
        table, n_rows, width, idx, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// dtype 0: float32 rows; 1: bf16 rows (their 16-bit patterns).  W a
// multiple of 8, at least kChaseCols; out (n,).
extern "C" int shimmer_row_chase(int dtype, const void* table, int n_rows,
                                 int width, const int* idx, int n, int steps,
                                 float* out, void* stream) {
  if (n_rows <= 0 || width < kChaseCols || width % 8 != 0 || n < 0 ||
      steps < 0 || (dtype != 0 && dtype != 1)) {
    return invalid();
  }
  if (n > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int blocks = blocks_for(n, kChaseThreads);
    if (dtype == 0) {
      row_chase_kernel<float><<<blocks, kChaseThreads, 0, s>>>(
          static_cast<const float*>(table), n_rows, width, idx, n, steps, out);
    } else {
      row_chase_kernel<uint16_t><<<blocks, kChaseThreads, 0, s>>>(
          static_cast<const uint16_t*>(table), n_rows, width, idx, n, steps,
          out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int shimmer_gather_sum_max_width() { return kSumMaxWidth; }
