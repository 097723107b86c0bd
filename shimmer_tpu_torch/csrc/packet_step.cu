// Packet-step experiment kernels for Hopper (sm_90a): the packet slab
// chase, the step attribution over the BVH8 rows, and the step ablation
// over a bf16 hi|lo table.
//
// Replace the Pallas kernels of the reference's packet-step experiments,
// which time what one traversal step of a 128-ray packet costs and which
// part of it (kernel-table rows 10-16 in PERF.md):
//   packet_slab_chase  experiments/exp_scaling.py:38 (make, called :47),
//                      exp_packet_step.py:40 (step_kernel, :87),
//                      exp_packet_step2.py:65 (make, fetch A-D, :66),
//                      exp_fetch_honest.py:82 (make, :92),
//                      exp_loop_overhead.py:57 (make, bodies k1-k6, :58);
//   step_attrib        exp_step_attrib.py:43 (kern, called :208);
//   step_ablate        exp_ablate_step.py:32 (kern; run, :126-143).
// The TPU's fetch strategies (lane roll of an aligned block, an MXU
// transpose, a relayout, 48 scalar reads) are ways to broadcast a node's
// 48 floats across the packet's lanes; on Hopper every thread reads the
// node's floats itself (the same addresses across a warp, one broadcast
// load each), and what remains of fetch A-D is the table's layout: rows
// (R, 128), 12 16-byte loads a node, or transposed (128, R), 48 loads
// each R * 4 bytes apart.
//
// What bounds them on the H100, and what the designs do about it: none is
// bound by bytes or operations.  Each is a chain of dependent steps, as
// the reference's function is one packet and one chain.
//   * packet_slab_chase: the slab bodies and the chain bodies are split
//     (packet_step_body.cuh, "Kernel A split"): the chain of r never
//     depends on a slab result, so one thread walks it alone, counting its
//     visits of each row in shared memory, from nxt staged there as byte
//     offsets when the chain is long enough to pay for the copy (one
//     dependent shared load a step, its result the next load's address);
//     then blocks of 128 threads, one a lane, take chunks of the visited
//     rows over the whole card, stage a batch of their nodes (48 box floats
//     each) in shared memory, and add count * hits per lane as integers,
//     met by integer atomics and converted to float by the last block to
//     finish.  A step then costs the walk's one dependent shared-memory
//     load; the slab tests, one per distinct row and lane (the chains of
//     the reference cases close a cycle within ~200 rows), run on every SM
//     instead of one packet's 4 warps.  A one-launch form, in which the
//     slab blocks took chunks of steps while the walk went on, measured
//     slower than two launches (PERF.md).  The bodies whose float sum
//     depends on its order (acc, acc_scaled) and int_sum keep the per-lane
//     loop of one block of 128 threads.
//   * step_attrib: one block of K packets (K * 128 threads) runs the G
//     programs in grid order, as interpret mode does, so each packet's
//     stack carries from one program to the next.  The stack lives in
//     shared memory, one copy per warp updated by the warp's lane 0 (the
//     scalar chain is uniform, so each warp runs it for itself behind
//     __syncwarp); the OR of the 128 lanes' hit bits is a __reduce_or_sync
//     per warp, combined across the packet's 4 warps in shared memory
//     behind one __syncthreads a step (double-buffered by step parity).
//     That reduction is what `nobits` leaves out.
//   * step_ablate: G blocks of 128 threads, each the same program; v3 and
//     v4 reduce their hit bits across the block as step_attrib does.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false (IEEE
// division; ops/cuda_build.py).  Each entry point launches on `stream`,
// does not synchronise, allocates nothing, and returns cudaGetLastError(),
// or cudaErrorInvalidValue for arguments the kernels do not take.

#include <cuda_runtime.h>

#include "packet_step_body.cuh"

namespace {

using namespace shimmer;
using namespace shimmer::packet;

// The per-lane loop of the bodies that keep it (int_sum, acc, acc_scaled):
// one packet, one block.
template <int kBody>
__global__ void __launch_bounds__(kLanes)
    packet_slab_chase_kernel(const float* __restrict__ table, int n_rows,
                             const int* __restrict__ nxt,
                             const float* __restrict__ rays, int steps,
                             float* __restrict__ out) {
  __shared__ volatile int side_stack[kSideStack];
  const int lane = threadIdx.x;
  out[lane] = slab_chase_lane<kBody, false>(table, n_rows, nxt, rays, lane,
                                            steps, side_stack);
}

// Rows of nxt and visit counts one block can hold: the dynamic shared
// memory a block may take on the H100 (227 KB) less room for the static.
constexpr int kMaxSharedRows = (227 * 1024 - 8 * 1024) / static_cast<int>(sizeof(int));

// The split chase's walk (packet_step_body.cuh, "Kernel A split"): the
// block zeroes the visit counts (in shared memory; the bodies that count)
// and stages nxt (kStaged), thread 0 walks the chain, then the block lists
// the visited rows and their counts in rows / counts with their number at
// n_items; the chain bodies write their output here instead.
template <int kBody, bool kStaged>
__global__ void __launch_bounds__(kLanes)
    chase_walk_kernel(const int* __restrict__ nxt, int n_rows, int steps,
                      int* __restrict__ rows, int* __restrict__ counts,
                      int* __restrict__ n_items, float* __restrict__ out) {
  constexpr bool kCount = kBody == kBodySlab || kBody == kBodySlabStack;
  extern __shared__ int smem[];
  int* visits = smem;
  int* staged = smem + (kCount ? n_rows : 0);
  __shared__ volatile int side_stack[kSideStack];
  __shared__ int last;
  __shared__ int listed;
  const int lane = threadIdx.x;
  if (kCount) {
    for (int r = lane; r < n_rows; r += kLanes) visits[r] = 0;
  }
  if (kStaged) stage_chain(nxt, n_rows, staged, lane, kLanes);
  if (lane == 0) listed = 0;
  __syncthreads();
  if (lane == 0) {
    last = chase_walk<kBody, kStaged>(nxt, staged, n_rows, steps, visits,
                                      side_stack);
  }
  __syncthreads();
  if (!kCount) {
    out[lane] = kBody == kBodyChase ? static_cast<float>(last) : 0.0f;
    return;
  }
  for (int r = lane; r < n_rows; r += kLanes) {
    if (visits[r] > 0) {
      const int k = atomicAdd(&listed, 1);
      rows[k] = r;
      counts[k] = visits[r];
    }
  }
  __syncthreads();
  if (lane == 0) *n_items = listed;
}

// The split chase's slab pass: block b takes items [b * chunk, (b + 1) *
// chunk) of the n_items the walk listed (slab_fixed: of its steps), thread
// `lane` sums count * hits of its lane over them as an integer, kSlabBatch
// items' nodes staged in shared memory at a time; the sums meet in acc by
// integer atomics, and the last block to finish writes them as float.  acc
// and done are zero at the launch.
template <int kBody, bool kTransposed>
__global__ void __launch_bounds__(kLanes)
    chase_slab_kernel(const float* __restrict__ table, int n_rows,
                      const float* __restrict__ rays, int steps,
                      const int* __restrict__ rows,
                      const int* __restrict__ counts,
                      const int* __restrict__ n_items, int* __restrict__ acc,
                      unsigned* __restrict__ done, float* __restrict__ out) {
  __shared__ float boxes[kSlabBatch][kBoxFloats];
  __shared__ int node[kSlabBatch];
  __shared__ int weight[kSlabBatch];
  __shared__ bool is_last;
  const int lane = threadIdx.x;
  const float ox = __ldg(rays + 0 * kLanes + lane);
  const float oy = __ldg(rays + 1 * kLanes + lane);
  const float oz = __ldg(rays + 2 * kLanes + lane);
  const float ix = __ldg(rays + 3 * kLanes + lane);
  const float iy = __ldg(rays + 4 * kLanes + lane);
  const float iz = __ldg(rays + 5 * kLanes + lane);
  const int items = kBody == kBodySlabFixed ? steps : *n_items;
  const int chunk = slab_chunk(slab_items(kBody, n_rows, steps));
  const int end = min((static_cast<int>(blockIdx.x) + 1) * chunk, items);
  int sum = 0;
  for (int b = blockIdx.x * chunk; b < end; b += kSlabBatch) {
    const int n = min(kSlabBatch, end - b);
    if (lane < n) {
      node[lane] = item_row<kBody>(rows, b + lane, n_rows);
      weight[lane] = item_count<kBody>(counts, b + lane);
    }
    __syncthreads();
    for (int k = lane; k < n * kBoxFloats; k += kLanes) {
      const int s = k / kBoxFloats;
      const int e = k - s * kBoxFloats;
      boxes[s][e] = box_element<kTransposed>(table, n_rows, node[s], e);
    }
    __syncthreads();
    for (int s = 0; s < n; ++s) {
      sum += weight[s] * slab_hit_count(boxes[s], ox, oy, oz, ix, iy, iz);
    }
    __syncthreads();
  }
  atomicAdd(acc + lane, sum);
  __threadfence();
  __syncthreads();
  if (lane == 0) is_last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (is_last) out[lane] = static_cast<float>(*(volatile int*)(acc + lane));
}

// OR of `mask` over the block's warps of one packet (kPacketWarps warps):
// one __syncthreads, the partials double-buffered by `parity`.
__device__ __forceinline__ int packet_or(int mask, int (*partial)[kPacketWarps],
                                         int warp, int& parity) {
  mask = static_cast<int>(__reduce_or_sync(0xffffffffu,
                                           static_cast<unsigned>(mask)));
  if (threadIdx.x % kWarp == 0) partial[parity][warp] = mask;
  __syncthreads();
  int bits = 0;
#pragma unroll
  for (int w = 0; w < kPacketWarps; ++w) bits |= partial[parity][w];
  parity ^= 1;
  return bits;
}

template <int kVariant>
__global__ void __launch_bounds__(kAttribMaxPackets * kLanes)
    step_attrib_kernel(const float* __restrict__ rows,
                       const int* __restrict__ meta, int n_rows,
                       const float* __restrict__ rays, int programs,
                       int steps, int stack_size, int* __restrict__ stack_io,
                       float* __restrict__ out) {
  __shared__ int stack[kAttribMaxPackets][kPacketWarps][kAttribMaxStack];
  __shared__ int partial[kAttribMaxPackets][2][kPacketWarps];
  const int packets = blockDim.x / kLanes;
  const int k = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int warp = lane / kWarp;
  const int wl = lane % kWarp;
  int* st = stack[k][warp];
  for (int s = wl; s < stack_size; s += kWarp) st[s] = stack_io[k * stack_size + s];
  int parity = 0;

  for (int g = 0; g < programs; ++g) {
    const int p = g * packets + k;
    __syncwarp();
    if (wl == 0) st[0] = 1;
    bool want_any;
    const Ray ray = attrib_ray(rays + (size_t)p * kAttribRayRows * kLanes,
                               lane, want_any);
    float t_best = kAttribTInit, tri = -1.0f, active = 1.0f;
    for (int i = 0; i < steps; ++i) {
      int r, cnt, m = 0, sp = 0;
      bool internal;
      __syncwarp();  // lane 0's stores of the last step before these reads
      if (kVariant == kAttribNoScalar) {
        r = static_cast<int>(static_cast<long long>(i) * (k + 3) % n_rows);
        cnt = r & 3;
        internal = (__ldg(meta + r) & 15) == 0;
      } else {
        const AttribPop pop = attrib_pop(st, stack_size, i, n_rows);
        __syncwarp();
        if (wl == 0) st[pop.sp] = pop.written;
        r = pop.r;
        sp = pop.sp;
        m = __ldg(meta + r);
        cnt = m & 15;
        internal = cnt == 0;
      }
      int node = r;
      if (kVariant == kAttribNoRoll) {
        node = r & ~7;
        internal = (__ldg(meta + node) & 15) == 0;
      }
      const float* row = rows + (size_t)node * kNodeWidth;
      int bits = kAttribConstBits;
      if (kVariant == kAttribFull || kVariant == kAttribNoRoll ||
          kVariant == kAttribNoLeaf) {
        bits = packet_or(attrib_internal_mask(row, internal, ray, t_best, active),
                         partial[k], warp, parity);
      }
      if (kVariant != kAttribNoScalar && wl == 0 && bits != 0) {
        st[attrib_push_slot(sp, stack_size)] = attrib_push_word(m, bits);
      }
      if (kVariant != kAttribNoLeaf) {
        attrib_leaf(row, internal, cnt, ray, want_any, t_best, tri, active);
      }
    }
    float* o = out + (size_t)p * kAttribOutRows * kLanes;
    o[lane] = t_best;
    o[kLanes + lane] = tri;
    for (int c = 2; c < kAttribOutRows; ++c) o[c * kLanes + lane] = 0.0f;
  }
  __syncwarp();
  if (warp == 0) {
    for (int s = wl; s < stack_size; s += kWarp) stack_io[k * stack_size + s] = st[s];
  }
}

template <int kVariant>
__global__ void __launch_bounds__(kLanes)
    step_ablate_kernel(const int* __restrict__ meta,
                       const float* __restrict__ tab,
                       const int* __restrict__ tab_i, int n_rows, int steps,
                       float* __restrict__ out) {
  __shared__ int partial[2][kPacketWarps];
  const int lane = threadIdx.x;
  const int warp = lane / kWarp;
  const float ox = ablate_ox(lane);
  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.0f;
  int parity = 0;
  int r = 1;
  for (int i = 0; i < steps; ++i) {
    if (kVariant == kAblateScalar) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = acc[j] + 1.0f;
      r = chase_next(meta, r, n_rows);
    } else if (kVariant == kAblateFetch32) {
      const float* row = tab + (size_t)r * kNodeWidth;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = acc[j] + __ldg(row + j);
      r = chase_next(meta, r, n_rows);
    } else if (kVariant == kAblateFetchBf) {
      const int mask = ablate_slab(tab_i + (size_t)r * kNodeWidth, ox, acc);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = acc[j] + ((mask >> j) & 1 ? 1.0f : 0.0f);
      r = chase_next(meta, r, n_rows);
    } else {
      int bits;
      if (kVariant == kAblateBits || (r & 1) == 0) {
        bits = packet_or(ablate_slab(tab_i + (size_t)r * kNodeWidth, ox, acc),
                         partial, warp, parity);
      } else {
        bits = ablate_leaf(tab + (size_t)r * kNodeWidth, acc);
      }
      r = chase_next(meta, (r + bits) & (n_rows - 1), n_rows);
    }
  }
  float* o = out + (size_t)blockIdx.x * 8 * kLanes;
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j * kLanes + lane] = acc[j] + static_cast<float>(r);
}

int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

using LaneKernel = void (*)(const float*, int, const int*, const float*, int,
                            float*);

LaneKernel lane_kernel_for(int body) {
  switch (body) {
    case kBodyIntSum: return packet_slab_chase_kernel<kBodyIntSum>;
    case kBodyAcc: return packet_slab_chase_kernel<kBodyAcc>;
    case kBodyAccScaled: return packet_slab_chase_kernel<kBodyAccScaled>;
    default: return nullptr;
  }
}

using WalkKernel = void (*)(const int*, int, int, int*, int*, int*, float*);

template <int kBody>
WalkKernel walk_kernel(bool staged) {
  return staged ? chase_walk_kernel<kBody, true> : chase_walk_kernel<kBody, false>;
}

// The walk of a split body (none for slab_fixed, which walks no chain).
WalkKernel walk_kernel_for(int body, bool staged) {
  switch (body) {
    case kBodySlab: return walk_kernel<kBodySlab>(staged);
    case kBodySlabStack: return walk_kernel<kBodySlabStack>(staged);
    case kBodyEmpty: return walk_kernel<kBodyEmpty>(staged);
    case kBodyChase: return walk_kernel<kBodyChase>(staged);
    default: return nullptr;
  }
}

using SlabKernel = void (*)(const float*, int, const float*, int, const int*,
                            const int*, const int*, int*, unsigned*, float*);

SlabKernel slab_kernel_for(int body, bool transposed) {
  if (body == kBodySlabFixed) {
    return transposed ? chase_slab_kernel<kBodySlabFixed, true>
                      : chase_slab_kernel<kBodySlabFixed, false>;
  }
  return transposed ? chase_slab_kernel<kBodySlab, true>
                    : chase_slab_kernel<kBodySlab, false>;
}

// The split chase: the walk (slab, slab_stack, empty, chase), then the
// slab pass (slab, slab_stack, slab_fixed).  nxt is staged when it fits
// beside the visit counts and the chain is long enough to pay for the copy
// (at least R / 64 steps; every reference case has at least 512 steps on
// R = 16,384).  work: rows and counts (min(steps, R) each, for the bodies
// that count), n_items, acc (kLanes), done.
int launch_split(int body, bool transposed, const float* table, int n_rows,
                 const int* nxt, const float* rays, int steps, int* work,
                 float* out, cudaStream_t st) {
  const int items = slab_items(body, n_rows, steps);
  const int listed = counts_visits(body) ? items : 0;
  int* rows = work;
  int* counts = work + listed;
  int* n_items = work + 2 * listed;
  int* acc = n_items + 1;
  unsigned* done = reinterpret_cast<unsigned*>(acc + kLanes);
  const int counted = counts_visits(body) ? n_rows : 0;
  if (counted > kMaxSharedRows) return invalid();
  const WalkKernel walk = walk_kernel_for(body, false);
  if (walk != nullptr) {
    const bool staged = counted + n_rows <= kMaxSharedRows && steps >= n_rows / 64;
    const WalkKernel kernel = walk_kernel_for(body, staged);
    const size_t smem = static_cast<size_t>(counted + (staged ? n_rows : 0)) * sizeof(int);
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<1, kLanes, smem, st>>>(nxt, n_rows, steps, rows, counts, n_items, out);
    if (counted == 0) return static_cast<int>(cudaGetLastError());  // a chain body
  }
  if (items == 0) {
    const cudaError_t e = cudaMemsetAsync(out, 0, kLanes * sizeof(float), st);
    return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
  }
  const cudaError_t e = cudaMemsetAsync(acc, 0, (kLanes + 1) * sizeof(int), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  slab_kernel_for(body, transposed)<<<slab_blocks(items), kLanes, 0, st>>>(
      table, n_rows, rays, steps, rows, counts, n_items, acc, done, out);
  return static_cast<int>(cudaGetLastError());
}

using AttribKernel = void (*)(const float*, const int*, int, const float*, int,
                              int, int, int*, float*);

AttribKernel attrib_kernel_for(int variant) {
  switch (variant) {
    case kAttribFull: return step_attrib_kernel<kAttribFull>;
    case kAttribNoRoll: return step_attrib_kernel<kAttribNoRoll>;
    case kAttribNoLeaf: return step_attrib_kernel<kAttribNoLeaf>;
    case kAttribNoInt: return step_attrib_kernel<kAttribNoInt>;
    case kAttribNoBits: return step_attrib_kernel<kAttribNoBits>;
    case kAttribNoScalar: return step_attrib_kernel<kAttribNoScalar>;
    default: return nullptr;
  }
}

using AblateKernel = void (*)(const int*, const float*, const int*, int, int,
                              float*);

AblateKernel ablate_kernel_for(int variant) {
  switch (variant) {
    case kAblateScalar: return step_ablate_kernel<kAblateScalar>;
    case kAblateFetch32: return step_ablate_kernel<kAblateFetch32>;
    case kAblateFetchBf: return step_ablate_kernel<kAblateFetchBf>;
    case kAblateBits: return step_ablate_kernel<kAblateBits>;
    case kAblateCond: return step_ablate_kernel<kAblateCond>;
    default: return nullptr;
  }
}

}  // namespace

// table (R, 128) float32, or (128, R) with `transposed`; nxt (R,) int32;
// rays (8, 128) float32; work (2 * min(steps, R) + 130,) int32 scratch of
// the slab and slab_stack bodies ((130,) for slab_fixed, empty and chase);
// out (128,) float32.  steps <= kChaseMaxSteps; slab and slab_stack take R
// <= kMaxSharedRows.
extern "C" int shimmer_packet_slab_chase(int body, int transposed,
                                         const float* table, int n_rows,
                                         const int* nxt, const float* rays,
                                         int steps, int* work, float* out,
                                         void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body < 0 || body >= kNumBodies || n_rows <= 0 || steps < 0 ||
      steps > kChaseMaxSteps) {
    return invalid();
  }
  if (is_split_body(body)) {
    return launch_split(body, transposed != 0, table, n_rows, nxt, rays, steps, work,
                        out, st);
  }
  lane_kernel_for(body)<<<1, kLanes, 0, st>>>(table, n_rows, nxt, rays, steps, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int shimmer_packet_slab_chase_max_steps() { return kChaseMaxSteps; }

extern "C" int shimmer_packet_slab_chase_max_rows() { return kMaxSharedRows; }

// rows (R, 128) float32 and meta (R,) int32 of a BVH8 table; rays
// (programs * packets, 16, 128) float32; stack (packets, stack_size)
// int32, the packets' stacks on entry, left as the last program left
// them; out (programs * packets, 8, 128) float32.
extern "C" int shimmer_step_attrib(int variant, const float* rows,
                                   const int* meta, int n_rows,
                                   const float* rays, int programs,
                                   int packets, int steps, int stack_size,
                                   int* stack, float* out, void* stream) {
  const AttribKernel kernel = attrib_kernel_for(variant);
  if (kernel == nullptr || n_rows <= 0 || programs < 0 || packets < 1 ||
      packets > kAttribMaxPackets || steps < 0 || stack_size < 1 ||
      stack_size > kAttribMaxStack) {
    return invalid();
  }
  kernel<<<1, packets * kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, meta, n_rows, rays, programs, steps, stack_size, stack, out);
  return static_cast<int>(cudaGetLastError());
}

// meta (R,) int32, R a power of two; tab (R, 128) float32; tab_i (R, 128)
// int32, the bf16 hi|lo words of tab; out (programs, 8, 128) float32.
extern "C" int shimmer_step_ablate(int variant, const int* meta,
                                   const float* tab, const int* tab_i,
                                   int n_rows, int programs, int steps,
                                   float* out, void* stream) {
  const AblateKernel kernel = ablate_kernel_for(variant);
  if (kernel == nullptr || n_rows < 2 || (n_rows & (n_rows - 1)) != 0 ||
      programs < 0 || steps < 0) {
    return invalid();
  }
  if (programs > 0) {
    kernel<<<programs, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
        meta, tab, tab_i, n_rows, steps, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int shimmer_step_attrib_max_packets() { return kAttribMaxPackets; }

extern "C" int shimmer_step_attrib_max_stack() { return kAttribMaxStack; }
