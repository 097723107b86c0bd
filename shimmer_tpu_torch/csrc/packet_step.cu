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
//   * step_attrib: the reference runs the G programs one after another and
//     carries each packet's stack from one to the next, which made the
//     first port one block of K packets stepping G * steps times in series
//     (19.00 ms at the reference's case on an NVIDIA H100 80GB HBM3 at
//     700.00 W, PERF.md).  But the carried chain never depends on a lane
//     (packet_step_body.cuh, "The chain in closed form"): every pop reads
//     slot 1, whose word after n pops has a closed form, and every push
//     lands in slot 2, which no pop reads.  So the kernel is G * K
//     independent blocks, one packet each: a block computes its steps'
//     visits from slot 1's starting word, then each lane runs its steps
//     with no block-wide barrier, each warp writing its OR of the lanes'
//     hit bits per step to shared memory, combined once after the steps.
//     The last push in grid order (slot 2's final word) is chosen by a
//     second, one-warp-a-packet launch that scans the blocks' records
//     from the last program down.  It was chosen over a 64-bit atomicMax
//     read by the last block to finish because it needs no zeroed scratch
//     (a memset is a launch too), no fence and no counter, and is
//     deterministic by construction; it costs one launch of K warps.  What
//     bounds a block is one packet's 256 steps of 8 slab tests on
//     L1-resident rows (read 16 bytes at a time), 4 warps on each of 128
//     of the 132 SMs at the reference's G = 64, K = 2: ~460 ns a step on
//     the same card.  Sharing a lane among 2, 4 or 8 threads (box and leaf
//     slots split among them, the leaf winners met by shuffles; 8-32 warps
//     an SM) was measured and dropped: 1.08-1.62x slower on the
//     reference's case, faster only where the chain walks the table and
//     tests leaves (PERF.md, the step attribution's design steps).
//   * step_ablate: the reference's G programs are equal, and each walks
//     its chain a step at a time; v3 and v4 wait a step for the lanes' OR
//     of hit bits before they read the next row, which made the first
//     port G blocks stepping 2,048 times in series (0.869 ms at the
//     reference's v4 case on an NVIDIA H100 80GB HBM3 at 700.00 W,
//     PERF.md).  But the next row is a function of the row alone
//     (packet_step_body.cuh, "The design"), so the chain is a walk on a
//     functional graph that closes a cycle within ~235 rows there, and
//     what a step adds to an accumulator is a function of its row.  So:
//     v3 and v4 first compute every row's next row over the card, a warp
//     a row (the row's packed columns read once and shuffled, 32 lanes a
//     slot tested at a time, a slot left at its first hit); then 32
//     blocks, each holding 32 of the 1,024 accumulators, stage the next
//     table (and a first-visit mark, 32 bits a row) in shared memory, walk
//     it in one thread to the first repeated row (one dependent shared
//     load a step), compute their accumulators' terms of the visited rows
//     side by side into shared memory, and one warp adds them in step
//     order: the first mu + lambda steps, whole laps of the cycle, then
//     the rest of the last lap, so that no add waits on the wrap of the
//     visit position (0.74-0.87x of a loop that wraps it a step).  The G
//     programs share this and get copies.  Measured and dropped (PERF.md):
//     each program computing its own (5-16x slower), terms read a batch
//     ahead of their adds (no faster; spills in v2) and a walk that reads
//     8 entries before it tests them (1.02-1.11x).  What bounds it now is
//     the walk (~200 dependent shared loads) and the 2,048 dependent adds
//     of one accumulator, not bytes or operations.  v0's sum of ones has
//     a closed form and needs no adds.
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

// Row 15, one block a packet of one program: block p is packet k = p %
// packets of program g = p / packets.  Per chunk of kAttribChunk steps the
// block computes the chunk's visits from slot 1's starting word in closed
// form (attrib_visit_at), one a thread, then every lane runs the chunk's
// steps with no block-wide barrier: a warp's OR of its lanes' hit bits for
// step s goes to bits[s][warp], and warp 0 combines them after the chunk,
// finding the chunk's last step that pushes.  The block's last push (its
// step + 1, 0 if none, and the word) goes to last[p] for the finish.
constexpr int kAttribChunk = 256;

template <int kVariant>
__global__ void __launch_bounds__(kLanes)
    step_attrib_kernel(const float* __restrict__ rows,
                       const int* __restrict__ meta, int n_rows,
                       const float* __restrict__ rays, int packets, int steps,
                       int stack_size, const int* __restrict__ stack,
                       int2* __restrict__ last, float* __restrict__ out) {
  __shared__ AttribVisit visits[kAttribChunk];
  __shared__ int bits[kAttribChunk][kPacketWarps];
  const int p = blockIdx.x;
  const int g = p / packets;
  const int k = p - g * packets;
  const int lane = threadIdx.x;
  const int warp = lane / kWarp;
  const int wl = lane % kWarp;
  const int e0 = __ldg(stack + k * stack_size + 1);
  bool want_any;
  const Ray ray = attrib_ray(rays + (size_t)p * kAttribRayRows * kLanes, lane,
                             want_any);
  float t_best = kAttribTInit, tri = -1.0f, active = 1.0f;
  int last_step = 0, last_word = 0;  // warp 0's record of the last push
  for (int c0 = 0; c0 < steps; c0 += kAttribChunk) {
    const int n = min(kAttribChunk, steps - c0);
    __syncthreads();  // warp 0 has read the last chunk's visits and bits
    for (int s = lane; s < n; s += kLanes) {
      visits[s] = attrib_visit_at(kVariant, meta, n_rows, e0, k, g, steps, c0 + s);
    }
    __syncthreads();
    for (int s = 0; s < n; ++s) {
      const int mask = attrib_lane_step<kVariant>(rows, visits[s], ray, want_any,
                                                  t_best, tri, active);
      if (attrib_tests_boxes(kVariant)) {
        const unsigned w = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(mask));
        if (wl == 0) bits[s][warp] = static_cast<int>(w);
      }
    }
    if (!attrib_pushes(kVariant)) continue;
    __syncthreads();
    if (warp == 0) {
      // The chunk's steps from the last down, a warp's width at a time:
      // the highest step whose combined bits are non-zero.
      for (int top = n - 1; top >= 0; top -= kWarp) {
        const int s = top - wl;
        int b = 0;
        if (s >= 0) {
          int lanes_or = 0;
          if (attrib_tests_boxes(kVariant)) {
#pragma unroll
            for (int w = 0; w < kPacketWarps; ++w) lanes_or |= bits[s][w];
          }
          b = attrib_step_bits(kVariant, lanes_or);
        }
        const unsigned found = __ballot_sync(0xffffffffu, b != 0);
        if (found != 0u) {
          const int src = __ffs(found) - 1;  // the lowest lane: the highest step
          const int bs = __shfl_sync(0xffffffffu, b, src);
          last_step = c0 + top - src + 1;
          last_word = attrib_push_word(visits[top - src].m, bs);
          break;
        }
      }
    }
  }
  float* o = out + (size_t)p * kAttribOutRows * kLanes;
  o[lane] = t_best;
  o[kLanes + lane] = tri;
  for (int c = 2; c < kAttribOutRows; ++c) o[c * kLanes + lane] = 0.0f;
  if (lane == 0) last[p] = make_int2(last_step, last_word);
}

// Row 15's finish, one warp a packet: the highest program whose block
// pushed (a warp's width of programs at a time, from the last), then the
// packet's stack (attrib_finish).
__global__ void step_attrib_finish_kernel(int variant, int programs,
                                          int packets, int steps,
                                          int stack_size,
                                          const int2* __restrict__ last,
                                          int* __restrict__ stack) {
  const int k = threadIdx.x / kWarp;
  const int wl = threadIdx.x % kWarp;
  if (k >= packets) return;
  int chosen = -1;
  for (int top = programs - 1; top >= 0; top -= kWarp) {
    const int g = top - wl;
    const bool pushed = g >= 0 && last[g * packets + k].x > 0;
    const unsigned found = __ballot_sync(0xffffffffu, pushed);
    if (found != 0u) {
      chosen = top - (__ffs(found) - 1);
      break;
    }
  }
  if (wl == 0) {
    attrib_finish(variant, stack + k * stack_size, programs, steps, chosen >= 0,
                  chosen >= 0 ? last[chosen * packets + k].y : 0);
  }
}

// Row 15's chain alone: the visits (r, meta[r]) of every program, packet
// and step, as the packet kernel computes them at each chunk's start.
__global__ void __launch_bounds__(kLanes)
    step_attrib_chain_kernel(int variant, const int* __restrict__ meta,
                             int n_rows, int packets, int steps,
                             int stack_size, const int* __restrict__ stack,
                             int2* __restrict__ visits) {
  const int p = blockIdx.x;
  const int g = p / packets;
  const int k = p - g * packets;
  const int e0 = __ldg(stack + k * stack_size + 1);
  for (int i = threadIdx.x; i < steps; i += kLanes) {
    const AttribVisit v = attrib_visit_at(variant, meta, n_rows, e0, k, g, steps, i);
    visits[(size_t)p * steps + i] = make_int2(v.r, v.m);
  }
}

// Row 16's next pass (v3, v4): one warp a row, next[r] = next_v(r).  The
// warp reads the row's packed columns 0-63 at once (two coalesced loads,
// a column a thread) and hands each slot's box values round by shuffles
// (the values ablate_slot_box reads); it tests 32 lanes of a slot at a
// time and stops the slot at the first group with a hit (the OR is then
// known); a slot whose field 48 + j is not > 0 tests no lane.
constexpr int kAblateNextWarps = 8;

template <int kVariant>
__global__ void __launch_bounds__(kAblateNextWarps * kWarp)
    ablate_next_kernel(const int* __restrict__ meta, const float* __restrict__ tab,
                       const int* __restrict__ tab_i, int n_rows, int* __restrict__ next) {
  const int r = blockIdx.x * kAblateNextWarps + threadIdx.x / kWarp;
  const int wl = threadIdx.x % kWarp;
  if (r >= n_rows) return;  // the whole warp
  int bits = 0;
  if (ablate_leaf_row(kVariant, r)) {
    bits = ablate_leaf_bits(tab + (size_t)r * kNodeWidth);
  } else {
    const int* wrow = tab_i + (size_t)r * kNodeWidth;
    const float lo = hilo_value(__ldg(wrow + wl));          // column wl
    const float hi = hilo_value(__ldg(wrow + kWarp + wl));  // column 32 + wl
    constexpr unsigned kAll = 0xffffffffu;
    for (int j = 0; j < 8; ++j) {
      if (!(__shfl_sync(kAll, hi, 16 + j) > 0.0f)) continue;  // field 48 + j
      const float c[4] = {__shfl_sync(kAll, lo, j), __shfl_sync(kAll, lo, 24 + j),
                          __shfl_sync(kAll, lo, 8 + j), __shfl_sync(kAll, hi, j)};
      for (int q = 0; q < kLanes; q += kWarp) {
        float tn;
        if (__any_sync(kAll, ablate_slot(c, ablate_ox(q + wl), tn))) {
          bits |= 1 << j;
          break;
        }
      }
    }
  }
  if (wl == 0) next[r] = ablate_next(meta, kVariant, r, bits, n_rows);
}

// Row 16's walk and sums: block b holds the accumulators (j, lane0 + l),
// l < kAblateChainLanes, j = b / 4, lane0 = 32 (b % 4).  It stages the
// walk's entries (the next row: v0-v2 clamped meta, v3 and v4 the next
// pass's), one thread walks them to the first repeated row, the block
// computes the visited rows' terms of its accumulators into shared memory
// (term_rows of them fit), one warp adds them in step order, and the
// block writes its accumulators into every program's block of out.
constexpr int kAblateThreads = 1024;
constexpr int kAblateBlocks = 8 * (kLanes / kAblateChainLanes);

template <int kVariant>
__global__ void __launch_bounds__(kAblateThreads)
    step_ablate_kernel(const int* __restrict__ meta, const float* __restrict__ tab,
                       const int* __restrict__ tab_i, const int* __restrict__ next_rows,
                       int n_rows, int programs, int steps, int term_rows,
                       float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char ablate_smem[];
  unsigned* entries = reinterpret_cast<unsigned*>(ablate_smem);
  unsigned short* seq = reinterpret_cast<unsigned short*>(entries + n_rows);
  float* terms = reinterpret_cast<float*>(ablate_smem + ablate_table_bytes(n_rows, steps));
  __shared__ AblateWalk walk;
  __shared__ float result[kAblateChainLanes];
  const int t = threadIdx.x;
  // Four rows a thread at a time (R is a power of two: a multiple of 4
  // from R = 4), their words read as one 16-byte load.
  const int quads = n_rows / 4;
  const int4* src = reinterpret_cast<const int4*>(ablate_needs_bits(kVariant) ? next_rows : meta);
  for (int q = t; q < quads; q += kAblateThreads) {
    const int4 m = __ldg(src + q);
    const int raw[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      entries[4 * q + i] = ablate_entry(ablate_needs_bits(kVariant) ? raw[i]
                                                                    : clamp_row(raw[i], n_rows));
    }
  }
  for (int r = 4 * quads + t; r < n_rows; r += kAblateThreads) {
    entries[r] = ablate_entry(ablate_needs_bits(kVariant) ? __ldg(next_rows + r)
                                                          : chase_next(meta, r, n_rows));
  }
  __syncthreads();
  if (t == 0) walk = ablate_walk(entries, seq, steps);
  __syncthreads();
  const AblateWalk w = walk;
  const int j = blockIdx.x / (kLanes / kAblateChainLanes);
  const int lane0 = (blockIdx.x % (kLanes / kAblateChainLanes)) * kAblateChainLanes;
  const int per_step = ablate_terms_per_step(kVariant);
  const bool held = w.length <= term_rows;
  if (per_step > 0 && held) {
    for (int k = t; k < w.length * kAblateChainLanes; k += kAblateThreads) {
      const int d = k / kAblateChainLanes;
      const int l = k - d * kAblateChainLanes;
      float v[2];
      ablate_terms(kVariant, tab, tab_i, seq[d], j, ablate_ox(lane0 + l), v);
      for (int i = 0; i < per_step; ++i) terms[(d * per_step + i) * kAblateChainLanes + l] = v[i];
    }
    __syncthreads();
  }
  if (t < kAblateChainLanes) {
    const float acc =
        held ? ablate_sum(kVariant, w, steps, AblateHeldTerms{terms, per_step, t})
             : ablate_sum(kVariant, w, steps,
                          AblateRowTerms{kVariant, tab, tab_i, seq, j, ablate_ox(lane0 + t)});
    result[t] = acc + static_cast<float>(w.last);
  }
  __syncthreads();
  for (int k = t; k < programs * kAblateChainLanes; k += kAblateThreads) {
    const int g = k / kAblateChainLanes;
    const int l = k - g * kAblateChainLanes;
    out[((size_t)g * 8 + j) * kLanes + lane0 + l] = result[l];
  }
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
                              int, int, const int*, int2*, float*);

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

using NextKernel = void (*)(const int*, const float*, const int*, int, int*);
using AblateKernel = void (*)(const int*, const float*, const int*, const int*, int, int, int,
                              int, float*);

NextKernel next_kernel_for(int variant) {
  switch (variant) {
    case kAblateBits: return ablate_next_kernel<kAblateBits>;
    case kAblateCond: return ablate_next_kernel<kAblateCond>;
    default: return nullptr;
  }
}

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
// them; work (programs * packets, 2) int32 scratch; out (programs *
// packets, 8, 128) float32.  Two launches: the packets, then the finish.
extern "C" int shimmer_step_attrib(int variant, const float* rows,
                                   const int* meta, int n_rows,
                                   const float* rays, int programs,
                                   int packets, int steps, int stack_size,
                                   int* stack, int* work, float* out,
                                   void* stream) {
  if (!attrib_args_ok(variant, n_rows, programs, packets, steps, stack_size)) {
    return invalid();
  }
  if (programs == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int2* last = reinterpret_cast<int2*>(work);
  attrib_kernel_for(variant)<<<programs * packets, kLanes, 0, st>>>(
      rows, meta, n_rows, rays, packets, steps, stack_size, stack, last, out);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  step_attrib_finish_kernel<<<1, packets * kWarp, 0, st>>>(
      variant, programs, packets, steps, stack_size, last, stack);
  return static_cast<int>(cudaGetLastError());
}

// Row 15's chain alone: visits (programs * packets, steps, 2) int32, the
// (r, meta[r]) of each step from the stacks' slot 1 (stack as
// shimmer_step_attrib takes it, read only).
extern "C" int shimmer_step_attrib_chain(int variant, const int* meta,
                                         int n_rows, int programs, int packets,
                                         int steps, int stack_size,
                                         const int* stack, int* visits,
                                         void* stream) {
  if (!attrib_args_ok(variant, n_rows, programs, packets, steps, stack_size)) {
    return invalid();
  }
  if (programs > 0 && steps > 0) {
    step_attrib_chain_kernel<<<programs * packets, kLanes, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        variant, meta, n_rows, packets, steps, stack_size, stack,
        reinterpret_cast<int2*>(visits));
  }
  return static_cast<int>(cudaGetLastError());
}

// meta (R,) int32, R a power of two, 2 <= R <= kAblateMaxRows; tab (R,
// 128) float32; tab_i (R, 128) int32, the bf16 hi|lo words of tab; work
// (R,) int32 scratch (v3, v4: the next table); out (programs, 8, 128)
// float32.  v3 and v4: two launches, the next pass and the walk and sums;
// v0-v2: the second alone.
extern "C" int shimmer_step_ablate(int variant, const int* meta,
                                   const float* tab, const int* tab_i,
                                   int n_rows, int programs, int steps,
                                   int* work, float* out, void* stream) {
  const AblateKernel kernel = ablate_kernel_for(variant);
  if (kernel == nullptr || n_rows < 2 || (n_rows & (n_rows - 1)) != 0 ||
      n_rows > kAblateMaxRows || programs < 0 || steps < 0) {
    return invalid();
  }
  if (programs == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ablate_needs_bits(variant)) {
    if (work == nullptr) return invalid();
    const int blocks = (n_rows + kAblateNextWarps - 1) / kAblateNextWarps;
    next_kernel_for(variant)<<<blocks, kAblateNextWarps * kWarp, 0, st>>>(meta, tab, tab_i,
                                                                       n_rows, work);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int term_rows = ablate_term_rows(variant, n_rows, steps);
  const int smem = ablate_table_bytes(n_rows, steps) +
                   term_rows * ablate_terms_per_step(variant) * kAblateChainLanes * 4;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<kAblateBlocks, kAblateThreads, smem, st>>>(meta, tab, tab_i, work, n_rows, programs,
                                                     steps, term_rows, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int shimmer_step_ablate_max_rows() { return kAblateMaxRows; }

extern "C" int shimmer_step_attrib_max_packets() { return kAttribMaxPackets; }

extern "C" int shimmer_step_attrib_max_stack() { return kAttribMaxStack; }
