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
//                     exp_pallas_gather2.py:74 (make_scalar_reduce);
//   row_gather_col_sum  repeats * sum_i T[idx[i], col]
//                     pallas_gather.py:181 (bench_pallas_dma, K = 4 passes
//                     over column 1);
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
//   * gather-sum: bytes of the distinct rows read, since the output is
//     one row, and at these sizes the latency of each step before the sum
//     can be written.  Read index by index, each occurrence of a row is
//     another 512-byte read: at R = 16,384 and N = 131,072 that is 67 MB
//     of L2 traffic for 8.4 MB of distinct rows, and the first port (a
//     cp.async ring per warp, blocks meeting in `out` by float atomics
//     after a memset) took 0.0157 ms (NVIDIA H100 80GB HBM3, 700.00 W).
//     So where gather_sum_counted says so (many indices over many wide
//     rows), the sum is counted, in one cooperative launch: the grid counts
//     the indices per row with integer atomics (exact in any order) into a
//     scratch that is zero at rest, waits for the whole count (a grid
//     barrier), then each warp reads the counts of its chunk of rows,
//     loads the rows that occur (16 bytes a lane, kSumRowsPerWarp rows in
//     flight), zeroes the counts it read and adds float(count) * row in
//     row order: each distinct row is read once, and no memset or second
//     launch is paid.  Elsewhere the direct form adds the indices' rows in
//     the same way with weight 1, one launch.  Both forms write a partial
//     per block (1,024 threads), and the last block to finish (by a
//     ticket) adds them in block order: no float atomics, so the sum is the
//     same bits on every run and in the host build (gather_body.cuh,
//     sum_warp_col).  A memset and three launches, shared-memory counts,
//     a finishing launch, 256 threads a block, fewer or more rows in
//     flight and a finish staged in shared memory were measured and
//     dropped (PERF.md).
//   * one-column sum (6D): one float of a row, a 32-byte sector, where a
//     whole-row sum reads 512 bytes; one thread an index, a shuffle tree
//     per warp, partials and a ticket as above, in one launch.  Its bound
//     (72 ns at N = 8,192) lies far below any launch: its time is the
//     launch and the chain of dependent accesses (index, value, partial,
//     ticket, partials), which floor_ms measures at N = 32.
//   * chase: neither bytes nor operations but the latency of K dependent
//     reads per lane (each step needs the last step's row to find the next
//     one), and the traffic of reaching them.  Read from the table, one
//     thread a lane reads only the 9 columns a step needs, through the
//     read-only path (36 bytes, two 32-byte sectors, for float32 rows; 18
//     bytes, one sector, for bf16 rows): at 131,072 lanes and K = 32 that
//     is 268 MB of L2 sectors for a 16,384-row table, which the first port
//     read at about the L2's sector rate (0.054 ms on an NVIDIA H100 80GB
//     HBM3 at 700.00 W), and a lane that reads few rows has nothing to
//     overlap (6E: 74 ns a step).  So where gather_body.cuh's chase_staged
//     says so (every chase case of the reference scripts, by the
//     measurement in PERF.md), a step is made short and the table is read
//     once: a pass over the card writes each row's (next index, row sum)
//     pair, and a grid of blocks, as many as the lanes' chunks need and
//     the card holds at once, stages the R + 1 pairs (128 KB at R =
//     16,384) in each block's shared memory with cp.async and walks its
//     chunks of lanes, one 8-byte shared load and an add a step: ~17 MB of
//     staging at 132 blocks instead of 268 MB of row sectors.  The per-lane
//     form stays for larger tables (R > kChaseStageMaxRows).
//
// And one kernel that replaces no TPU kernel (the reference leaves the
// gradient of a gather to XLA):
//   row_scatter_add   out[r, c] = sum over lanes i with idx[i] == r of
//                     grad[i, c], for a table of at most 32 rows of 2-32
//                     floats: the backward of the port's small-table
//                     gathers (ops/gather.py gather_rows).
//   * Its order is fixed: from 0.0f, one float32 add a lane, in ascending
//     lane order, which is the order torch's own backward of table[idx]
//     adds in on the card (a stable sort of the ids, then one thread a
//     (row, column) walks the row's lanes: indexing_backward_kernel_
//     small_stride), so the two agree bit for bit.  The bound is then that
//     chain of dependent adds, ~4 cycles a lane of the longest row (0.3 ms
//     for 131,072 lanes), where torch's walk pays dependent global loads a
//     lane (~22 ms a call at that size).  So one block a row streams the
//     ids in chunks: 16 warps compact the row's lanes of a chunk (a ballot a
//     32 lanes, a scan over the warps) and stage their gradient values in
//     shared memory, column by column in lane order, while a 17th warp,
//     one lane a column, walks the chunk staged before (two buffers): four
//     16-byte loads for each 16 values, issued ahead of the adds, its sum in a
//     register across chunks.  No sort, no atomics, one launch.  A first
//     form that staged whole rows and walked them with strided loads in
//     branches ran ~25 cycles a lane, the loads' latency exposed (PERF.md
//     §6).

// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
// (ops/cuda_build.py).  Each entry point launches on `stream`, does not
// synchronise, allocates nothing, and returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments the kernels do not take.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "gather_body.cuh"

namespace {

using namespace shimmer::gather;

constexpr int kWarp = 32;
constexpr int kGatherWarps = 8;       // rows per block of row_gather
constexpr int kColsThreads = 256;     // output elements per block, direct cols form
constexpr int kStageThreads = 512;    // staged cols form
constexpr int kChaseThreads = 128;
constexpr int kPairThreads = 256;     // rows per block of the chase's pair pass

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem)
               : "memory");
}

// True in the last block of the grid to get here, after every block's
// global writes before the call are visible to it; that block resets the
// ticket to 0 for the next launch on the stream.
__device__ bool last_block(int* ticket) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (last) {
    __threadfence();
    if (threadIdx.x == 0) *ticket = 0;
  }
  return last;
}

// One block's partial of the gather-sum over `items` items (gather_body.cuh):
// counted, item r is row r with weight counts[r], which the block resets to
// 0 once read; direct, item i is row idx[i] with weight 1.  Lane l holds
// columns 4l .. 4l + 3; a warp loads its chunk's weights, then the rows of
// weight > 0 (kSumRowsPerWarp in flight), then adds them in order.
template <bool kCounted>
__device__ void sum_block_partial(const float* __restrict__ table, int n_rows,
                                  int width, const int* __restrict__ idx,
                                  int* counts, int items,
                                  float* __restrict__ partials) {
  __shared__ float part[kSumWarps][kSumMaxWidth];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int col = 4 * lane;
  const bool has_cols = col < width;
  const int chunks = sum_chunks(items);
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int c = blockIdx.x * kSumWarps + warp; c < chunks; c += gridDim.x * kSumWarps) {
    int row[kSumRowsPerWarp], weight[kSumRowsPerWarp];
#pragma unroll
    for (int j = 0; j < kSumRowsPerWarp; ++j) {
      const int i = c * kSumRowsPerWarp + j;
      row[j] = i < items ? sum_item_row(kCounted, idx, i) : 0;
      weight[j] = i < items ? sum_item_weight(kCounted, counts, row[j], n_rows) : 0;
    }
    float4 v[kSumRowsPerWarp];
#pragma unroll
    for (int j = 0; j < kSumRowsPerWarp; ++j) {
      v[j] = weight[j] != 0 && has_cols
                 ? __ldg(reinterpret_cast<const float4*>(
                       table + static_cast<size_t>(row[j]) * width + col))
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    if (kCounted) {
      __syncwarp();
#pragma unroll
      for (int j = 0; j < kSumRowsPerWarp; ++j) {
        if (lane == 0 && weight[j] != 0) counts[row[j]] = 0;
      }
    }
#pragma unroll
    for (int j = 0; j < kSumRowsPerWarp; ++j) {
      if (weight[j] != 0) {
        acc.x = sum_weighted(acc.x, weight[j], v[j].x);
        acc.y = sum_weighted(acc.y, weight[j], v[j].y);
        acc.z = sum_weighted(acc.z, weight[j], v[j].z);
        acc.w = sum_weighted(acc.w, weight[j], v[j].w);
      }
    }
  }
  if (has_cols) {
    part[warp][col + 0] = acc.x;
    part[warp][col + 1] = acc.y;
    part[warp][col + 2] = acc.z;
    part[warp][col + 3] = acc.w;
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t < width) {
    float s = part[0][t];
    for (int w = 1; w < kSumWarps; ++w) s = s + part[w][t];
    partials[static_cast<size_t>(blockIdx.x) * width + t] = s;
  }
}

// The last block's finish: the grid's partials added per column in block
// order.
__device__ void finish_sum(const float* __restrict__ partials, int width,
                           float* __restrict__ out) {
  const int t = threadIdx.x;
  if (t < width) {
    float s = __ldcg(partials + t);
    for (int b = 1; b < static_cast<int>(gridDim.x); ++b) {
      s = s + __ldcg(partials + static_cast<size_t>(b) * width + t);
    }
    out[t] = s;
  }
}

// The direct gather-sum: grid sum_blocks(n); scratch[0] the ticket.
__global__ void __launch_bounds__(kSumWarps * kWarp)
    direct_sum_kernel(const float* __restrict__ table, int n_rows, int width,
                      const int* __restrict__ idx, int n,
                      float* __restrict__ partials, int* scratch,
                      float* __restrict__ out) {
  sum_block_partial<false>(table, n_rows, width, idx, nullptr, n, partials);
  if (last_block(scratch)) finish_sum(partials, width, out);
}

// The counted gather-sum in one cooperative launch (every block resident):
// the grid counts the indices into scratch[1 ..] (integer atomics, exact
// in any order), waits for the whole count, then sums the rows by their
// counts, zeroing each count it read; scratch[0] the ticket.  grid:
// sum_blocks(R).
__global__ void __launch_bounds__(kSumWarps * kWarp)
    counted_sum_kernel(const float* __restrict__ table, int n_rows, int width,
                       const int* __restrict__ idx, int n,
                       float* __restrict__ partials, int* scratch,
                       float* __restrict__ out) {
  int* counts = scratch + 1;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int r = __ldg(idx + i);
    if (in_range(r, n_rows)) atomicAdd(counts + r, 1);
  }
  __threadfence();
  cooperative_groups::this_grid().sync();
  sum_block_partial<true>(table, n_rows, width, idx, counts, n_rows, partials);
  if (last_block(scratch)) finish_sum(partials, width, out);
}

// The one-column sum (gather_body.cuh, col_sum_thread): grid
// col_sum_blocks(n) blocks; partials: one float a block; scratch[0] the
// ticket.
__global__ void __launch_bounds__(kColSumThreads)
    col_sum_kernel(const float* __restrict__ table, int n_rows, int width,
                   const int* __restrict__ idx, int n, int col, int repeats,
                   float* __restrict__ partials, int* scratch,
                   float* __restrict__ out) {
  __shared__ float warp_sum[kColSumThreads / kWarp];
  float s = col_sum_thread(table, n_rows, width, idx, n, col,
                           blockIdx.x * kColSumThreads + threadIdx.x,
                           gridDim.x * kColSumThreads);
  for (int off = kWarp / 2; off > 0; off /= 2) {
    s = s + __shfl_down_sync(0xffffffffu, s, off);
  }
  if (threadIdx.x % kWarp == 0) warp_sum[threadIdx.x / kWarp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float b = warp_sum[0];
    for (int w = 1; w < kColSumThreads / kWarp; ++w) b = b + warp_sum[w];
    partials[blockIdx.x] = b;
  }
  if (!last_block(scratch)) return;
  if (threadIdx.x == 0) {
    float total = __ldcg(partials);
    for (int b = 1; b < static_cast<int>(gridDim.x); ++b) total = total + __ldcg(partials + b);
    out[0] = static_cast<float>(repeats) * total;
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

// The staged chase's pass: pair r of the table for r < R, and at R the
// pair of the row of zeros.
template <typename T>
__global__ void __launch_bounds__(kPairThreads)
    chase_pairs_kernel(const T* __restrict__ table, int n_rows, int width,
                       ChasePair* __restrict__ pairs) {
  const int r = blockIdx.x * kPairThreads + threadIdx.x;
  if (r <= n_rows) pairs[r] = chase_pair(table, n_rows, width, r);
}

// The staged chase's walk: each block copies the R + 1 pairs into its
// shared memory (16 bytes a cp.async), then walks its chunks of lanes
// (chase_walk_chunk), one 8-byte shared load and an add a step.
__global__ void __launch_bounds__(kWalkThreads)
    chase_walk_kernel(const ChasePair* __restrict__ pairs, int n_rows,
                      const int* __restrict__ idx, int n, int steps,
                      float* __restrict__ out) {
  extern __shared__ ChasePair staged[];
  const int entries = n_rows + 1;
  for (int c = threadIdx.x; 2 * c + 1 < entries; c += blockDim.x) {
    cp_async16(staged + 2 * c, pairs + 2 * c);
  }
  if (threadIdx.x == 0 && entries % 2 == 1) staged[entries - 1] = pairs[entries - 1];
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  for (int c = blockIdx.x; c < walk_chunks(n); c += gridDim.x) {
    chase_walk_chunk(staged, n_rows, idx, n, steps, c, threadIdx.x, out);
  }
}

// row_scatter_add: kScatterWarps warps compact a chunk of lanes, then one
// more warp walks it.  A chunk is kScatterWarps * 32 * rounds lanes
// (scatter_rounds: as many rounds of 32 lanes a warp, up to
// kScatterMaxRounds, as keep a buffer of the chunk's gradient values within
// kScatterStageFloats).  A buffer holds the chunk's matched values column by
// column, each column scatter_stride(rounds) floats: the chunk and
// kScatterPad floats that the walk may read and never adds.
constexpr int kScatterMaxRows = 32;
constexpr int kScatterMinWidth = 2;
constexpr int kScatterMaxWidth = 32;
constexpr int kScatterWarps = 16;
constexpr int kScatterThreads = (kScatterWarps + 1) * kWarp;
constexpr int kScatterMaxRounds = 8;
constexpr int kScatterStageFloats = kScatterWarps * kWarp * kScatterMaxWidth;  // 64 KB
constexpr int kScatterPad = 16;

int scatter_rounds(int width) {
  const int rounds = kScatterStageFloats / (kScatterWarps * kWarp * width);
  return rounds < kScatterMaxRounds ? rounds : kScatterMaxRounds;
}

__host__ __device__ int scatter_stride(int rounds) {
  return kScatterWarps * kWarp * rounds + kScatterPad;
}

// Compacts the lanes [begin, begin + chunk) whose id is `row` into `buf`, in
// lane order: value c of the k-th such lane at buf[c * stride + k]; `*count`
// gets how many.  Run by the kScatterWarps compacting warps, each over its
// own `rounds` x 32 consecutive lanes.
__device__ void scatter_compact(const float* __restrict__ grad,
                                const long long* __restrict__ idx, long long n,
                                int width, int rounds, int row, long long begin,
                                float* __restrict__ buf, int* warp_count,
                                int* count) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int stride = scatter_stride(rounds);
  const long long seg = begin + static_cast<long long>(warp) * rounds * kWarp;
  long long ids[kScatterMaxRounds];
#pragma unroll
  for (int r = 0; r < kScatterMaxRounds; ++r) {
    const long long i = seg + r * kWarp + lane;
    ids[r] = r < rounds && i < n ? __ldg(idx + i) : -1;
  }
  unsigned masks[kScatterMaxRounds];
  int total = 0;
#pragma unroll
  for (int r = 0; r < kScatterMaxRounds; ++r) {
    masks[r] = __ballot_sync(0xffffffffu, ids[r] == row);
    total += __popc(masks[r]);
  }
  if (lane == 0) warp_count[warp] = total;
  // The compacting warps alone (barrier 0 is __syncthreads').
  asm volatile("bar.sync 1, %0;\n" ::"r"(kScatterWarps * kWarp) : "memory");
  int base = 0;
  for (int w = 0; w < warp; ++w) base += warp_count[w];
  if (warp == kScatterWarps - 1 && lane == 0) *count = base + total;
  // A matched lane copies its gradient row, four values in flight at a
  // time (the rounds past `rounds` matched none).
#pragma unroll
  for (int r = 0; r < kScatterMaxRounds; ++r) {
    const unsigned m = masks[r];
    if (m >> lane & 1u) {
      float* dst = buf + base + __popc(m & ((1u << lane) - 1u));
      const float* src = grad + (seg + r * kWarp + lane) * width;
      for (int c0 = 0; c0 < width; c0 += 4) {
        float v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) v[u] = c0 + u < width ? __ldg(src + c0 + u) : 0.0f;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (c0 + u < width) dst[(c0 + u) * stride] = v[u];
        }
      }
    }
    base += __popc(m);
  }
}

// Adds a column's `count` staged values (16-byte aligned, followed by
// kScatterPad readable floats) to `acc`, one add a value in order.  Sixteen
// values a step come in four 16-byte loads, issued for the next step before
// this step's adds, so the chain of adds sets the pace.
__device__ float scatter_walk(const float* col, int count, float acc) {
  const float4* q = reinterpret_cast<const float4*>(col);
  float4 a0 = q[0], a1 = q[1], a2 = q[2], a3 = q[3];
  int j = 0;
  for (; j + 16 <= count; j += 16) {
    const float4* nq = q + (j + 16) / 4;
    const float4 b0 = nq[0], b1 = nq[1], b2 = nq[2], b3 = nq[3];
    acc += a0.x; acc += a0.y; acc += a0.z; acc += a0.w;
    acc += a1.x; acc += a1.y; acc += a1.z; acc += a1.w;
    acc += a2.x; acc += a2.y; acc += a2.z; acc += a2.w;
    acc += a3.x; acc += a3.y; acc += a3.z; acc += a3.w;
    a0 = b0; a1 = b1; a2 = b2; a3 = b3;
  }
  for (; j < count; ++j) acc += col[j];
  return acc;
}

// One block a table row.  Warps 0-15 compact chunk k + 1 while warp 16
// walks chunk k, lane c column c; a __syncthreads between chunks hands the
// buffers over.
__global__ void __launch_bounds__(kScatterThreads)
    row_scatter_add_kernel(const float* __restrict__ grad,
                           const long long* __restrict__ idx, long long n,
                           int width, int rounds, float* __restrict__ out) {
  extern __shared__ __align__(16) float stage[];
  __shared__ int warp_count[kScatterWarps];
  __shared__ int chunk_count[2];
  const int row = blockIdx.x;
  const bool walker = threadIdx.x / kWarp == kScatterWarps;
  const int c = threadIdx.x % kWarp;
  const int chunk = kScatterWarps * kWarp * rounds;
  const int stride = scatter_stride(rounds);
  const int buf_floats = stride * width;
  const long long chunks = (n + chunk - 1) / chunk;
  if (!walker && chunks > 0) {
    scatter_compact(grad, idx, n, width, rounds, row, 0, stage, warp_count,
                    &chunk_count[0]);
  }
  float acc = 0.0f;
  for (long long k = 0; k < chunks; ++k) {
    __syncthreads();
    const int b = static_cast<int>(k & 1);
    if (walker) {
      if (c < width) {
        acc = scatter_walk(stage + b * buf_floats + c * stride, chunk_count[b], acc);
      }
    } else if (k + 1 < chunks) {
      scatter_compact(grad, idx, n, width, rounds, row, (k + 1) * chunk,
                      stage + (1 - b) * buf_floats, warp_count, &chunk_count[1 - b]);
    }
  }
  if (walker && c < width) out[row * width + c] = acc;
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

// W a positive multiple of 4, at most kSumMaxWidth; out (W,).  partials:
// kSumMaxBlocks * W floats.  scratch: int32, 0 at rest (each launch leaves
// it so), used by one launch at a time: scratch[0] the ticket, and where
// gather_sum_counted(n_rows, n, W) the R counts after it.  One launch
// either way (counted: a cooperative one).
extern "C" int shimmer_row_gather_sum(const float* table, int n_rows,
                                      int width, const int* idx, int n,
                                      float* partials, int* scratch, float* out,
                                      void* stream) {
  if (n_rows <= 0 || width <= 0 || width % 4 != 0 || width > kSumMaxWidth ||
      n < 0 || partials == nullptr || scratch == nullptr) {
    return invalid();
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!gather_sum_counted(n_rows, n, width)) {
    direct_sum_kernel<<<sum_blocks(n), kSumWarps * kWarp, 0, s>>>(
        table, n_rows, width, idx, n, partials, scratch, out);
    return static_cast<int>(cudaGetLastError());
  }
  void* args[] = {&table, &n_rows, &width, &idx, &n, &partials, &scratch, &out};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(counted_sum_kernel), dim3(sum_blocks(n_rows)),
      dim3(kSumWarps * kWarp), args, 0, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// repeats * sum_i T[idx[i], col] into out (one float); 0 <= col < W,
// 0 <= repeats <= kColSumMaxRepeats.  partials: kColSumMaxBlocks floats;
// scratch[0] the ticket, as for shimmer_row_gather_sum.  One launch.
extern "C" int shimmer_row_gather_col_sum(const float* table, int n_rows,
                                          int width, const int* idx, int n,
                                          int col, int repeats, float* partials,
                                          int* scratch, float* out, void* stream) {
  if (n_rows <= 0 || width <= 0 || n < 0 || col < 0 || col >= width ||
      repeats < 0 || repeats > kColSumMaxRepeats || partials == nullptr ||
      scratch == nullptr) {
    return invalid();
  }
  col_sum_kernel<<<col_sum_blocks(n), kColSumThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      table, n_rows, width, idx, n, col, repeats, partials, scratch, out);
  return static_cast<int>(cudaGetLastError());
}

// The staged walk over pairs (n_rows + 1 of them): blocks of
// walk_threads(n) threads, as many as the lanes' chunks need, at most as
// many as the card holds at once (each block stages the pairs once and
// takes chunks in turn).
int launch_walk(const ChasePair* pairs, int n_rows, const int* idx, int n,
                int steps, float* out, cudaStream_t s) {
  const int smem = static_cast<int>(sizeof(ChasePair)) * (n_rows + 1);
  cudaError_t err = cudaFuncSetAttribute(
      chase_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chase_walk_kernel,
                                                        walk_threads(n), smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int resident = sms * per_sm;
  if (resident < 1) return invalid();
  const int blocks = walk_chunks(n) < resident ? walk_chunks(n) : resident;
  chase_walk_kernel<<<blocks, walk_threads(n), smem, s>>>(pairs, n_rows, idx, n, steps, out);
  return static_cast<int>(cudaGetLastError());
}

// dtype 0: float32 rows; 1: bf16 rows (their 16-bit patterns).  W a
// multiple of 8, at least kChaseCols; out (n,).  work: 2 * (n_rows + 1)
// int32 of scratch where chase_staged(n_rows, n, steps) (the pairs; two
// launches, the pass and the walk), else unused and may be null.
extern "C" int shimmer_row_chase(int dtype, const void* table, int n_rows,
                                 int width, const int* idx, int n, int steps,
                                 int* work, float* out, void* stream) {
  if (n_rows <= 0 || width < kChaseCols || width % 8 != 0 || n < 0 ||
      steps < 0 || (dtype != 0 && dtype != 1)) {
    return invalid();
  }
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chase_staged(n_rows, n, steps)) {
    if (work == nullptr) return invalid();
    ChasePair* pairs = reinterpret_cast<ChasePair*>(work);
    const int blocks = blocks_for(n_rows + 1, kPairThreads);
    if (dtype == 0) {
      chase_pairs_kernel<float><<<blocks, kPairThreads, 0, s>>>(
          static_cast<const float*>(table), n_rows, width, pairs);
    } else {
      chase_pairs_kernel<uint16_t><<<blocks, kPairThreads, 0, s>>>(
          static_cast<const uint16_t*>(table), n_rows, width, pairs);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    return launch_walk(pairs, n_rows, idx, n, steps, out, s);
  }
  const int blocks = blocks_for(n, kChaseThreads);
  if (dtype == 0) {
    row_chase_kernel<float><<<blocks, kChaseThreads, 0, s>>>(
        static_cast<const float*>(table), n_rows, width, idx, n, steps, out);
  } else {
    row_chase_kernel<uint16_t><<<blocks, kChaseThreads, 0, s>>>(
        static_cast<const uint16_t*>(table), n_rows, width, idx, n, steps,
        out);
  }
  return static_cast<int>(cudaGetLastError());
}

// The staged chase's walk alone, over pairs (n_rows + 1, 2) int32 (next
// index, row-sum bits) that the caller made; n >= 1, n_rows <=
// kChaseStageMaxRows.
extern "C" int shimmer_chase_walk(const int* pairs, int n_rows, const int* idx,
                                  int n, int steps, float* out, void* stream) {
  if (n_rows <= 0 || n_rows > kChaseStageMaxRows || n < 1 || steps < 0) {
    return invalid();
  }
  return launch_walk(reinterpret_cast<const ChasePair*>(pairs), n_rows, idx, n,
                     steps, out, static_cast<cudaStream_t>(stream));
}

// grad (n, W) float32, W in [kScatterMinWidth, kScatterMaxWidth]; idx (n,)
// int64; out (n_rows, W), 1 <= n_rows <= kScatterMaxRows, every element
// written.  An id outside [0, n_rows) adds nothing.  One launch, n_rows
// blocks.
extern "C" int shimmer_row_scatter_add(const float* grad, const long long* idx,
                                       int n, int n_rows, int width, float* out,
                                       void* stream) {
  if (n < 0 || n_rows < 1 || n_rows > kScatterMaxRows || width < kScatterMinWidth ||
      width > kScatterMaxWidth) {
    return invalid();
  }
  const int rounds = scatter_rounds(width);
  const int smem = static_cast<int>(sizeof(float)) * 2 * scatter_stride(rounds) * width;
  const cudaError_t err = cudaFuncSetAttribute(
      row_scatter_add_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  row_scatter_add_kernel<<<n_rows, kScatterThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      grad, idx, n, width, rounds, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int shimmer_scatter_max_rows() { return kScatterMaxRows; }

extern "C" int shimmer_scatter_min_width() { return kScatterMinWidth; }

extern "C" int shimmer_scatter_max_width() { return kScatterMaxWidth; }

// The dispatch rule's bounds, which the wrapper's copy of the rule
// (ops/gather.py chase_staged) is checked against.
extern "C" int shimmer_chase_stage_max_lanes() { return kChaseStageMaxLanes; }

extern "C" int shimmer_chase_stage_max_rows() { return kChaseStageMaxRows; }

extern "C" int shimmer_chase_stage_min_steps() { return kChaseStageMinSteps; }

extern "C" int shimmer_chase_wide_min_steps() { return kChaseWideMinSteps; }

extern "C" int shimmer_chase_many_lanes() { return kChaseManyLanes; }

extern "C" int shimmer_chase_many_lanes_min_steps() { return kChaseManyLanesMinSteps; }

extern "C" int shimmer_gather_sum_max_width() { return kSumMaxWidth; }

extern "C" int shimmer_gather_sum_max_blocks() { return kSumMaxBlocks; }

extern "C" int shimmer_gather_sum_counted_max_n() { return kSumCountedMaxN; }

extern "C" int shimmer_gather_sum_counted_indices_per_row() { return kSumCountedIndicesPerRow; }

extern "C" int shimmer_gather_sum_counted_min_rows() { return kSumCountedMinRows; }

extern "C" int shimmer_gather_sum_counted_min_width() { return kSumCountedMinWidth; }

extern "C" int shimmer_col_sum_max_blocks() { return kColSumMaxBlocks; }

extern "C" int shimmer_col_sum_max_repeats() { return kColSumMaxRepeats; }
