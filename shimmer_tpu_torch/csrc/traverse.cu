// BVH8 closest-hit / any-hit traversal kernels for Hopper (sm_90a): v1 with
// its leaf variants, and v2.
//
// Replaces the packet kernels of shimmer_tpu/ops/pallas/traverse.py in all
// their forms on the render path:
//   * _traverse_kernel (v1) on resident tables (kernel-table row 1) and in
//     its streamed large-table form (row 2, stream=True: cold node tiles
//     DMA'd from HBM once the table outgrows VMEM).  Here every table is
//     read from HBM through L2 whatever its size, so one kernel serves both;
//   * v1 with Moller-Trumbore leaves (row 3, SHIMMER_LEAF_MT=1):
//     kLeaf = kLeafMT;
//   * v1 with the min-reduce winner id (row 4, SHIMMER_WINID_MIN=1):
//     kWinner = kWinnerMinId;
//   * _traverse_kernel_v2 (row 5, SHIMMER_KERNEL_V1=0): near-first ordered
//     pops and a postponed-leaf backlog (traverse_v2_body.cuh).
// The TPU kernels' structure (128-ray packets sharing one stack, 4
// interleaved chains, packet groups, the (8, 128) tiles8 layout, VMEM
// residency and tile streaming) answers TPU constraints and is not carried
// over; of tiles8 only v2's child-leaf column survives, as one int32 per
// row.  Here one thread traces one ray with its own stacks, 128 threads per
// block.
//
// What bounds them on the H100: chains of dependent row reads (each visit
// needs the previous row's result to pick the next row) and how a warp's 32
// rays spread over rows and over lifetimes, not FLOPs.  The bench table
// (76,590 rows, 39 MB) fits in the 50 MB L2, the 1.3M-triangle table
// (295,034 rows, 152 MB) does not, though one batch's rays touch a far
// smaller part of it.  Tensor cores have no part here: a traversal step is
// 8 slab or 8 triangle tests chosen by the data, with no matrix product.
//
// Both kernels, redesigned for Hopper (each step timed on its own in
// PERF.md), answer each limit:
//   * node reads as 16-byte loads: 14 for an internal row, 9 per quad of
//     triangles for a leaf, instead of 56 and 72 scalar loads, so a visit
//     waits on a few wide reads of its row instead of many narrow ones;
//   * near-first order: t_best tightens early; v1 drops stack entries
//     whose nearest child enters beyond it without a visit (fewer visits,
//     and the longest rays, which hold a warp, far shorter).
// Each keeps its stacks local arrays, bounded by a proof, not a guard (v1
// in traverse_body.cuh above V1Ray, v2 in traverse_v2_body.cuh above
// V2Ray).  Steps measured no faster were dropped: for v1 the stack in
// shared memory (within the run-to-run spread) and persistent warps
// fetching rays from a global counter (Aila and Laine, "Understanding the
// Efficiency of Ray Traversal on GPUs", HPG 2009; slower at every refill
// threshold tried), for v2 the pruned pops (the leaf backlog postpones the
// hits that would prune).  v2 adds a leaf backlog that lets every loop step
// retire one internal and one leaf visit, at the price of a second
// per-thread stack, and reads a hit child's leaf bit from its parent's
// child-leaf word instead of the child's meta word.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
// (see shimmer_tpu_torch/ops/cuda_build.py).  -fmad=false keeps the leaf
// tests bit-identical to the plain torch version and the re-intersection.

#include <cuda_runtime.h>

#include "traverse_v2_body.cuh"

using namespace shimmer;

namespace {

constexpr int kThreads = 128;

// One launch's arguments (see shimmer_traverse_launch).
struct Args {
  const float* rows;
  const int* meta;
  const int* child_leaf;
  int n_rows;
  const float* o;
  const float* d;
  const float* t_max;
  const uint8_t* any_hit;
  float* t_out;
  int* tri_out;
  int* steps_out;
  uint8_t* touched;
  int n;
};

// One ray per thread: v1 (V1Ray over a local stack) or v2 (V2Ray over its
// two local stacks).
template <int kKernel, int kLeaf, int kWinner>
__global__ void __launch_bounds__(kThreads) traverse_kernel(const Args a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  RayResult r;
  if constexpr (kKernel == 2) {
    V2Entry istack[kMaxStack];
    int lstack[kLeafStack];
    V2Ray ray;
    if (ray.start(a.o[3 * i + 0], a.o[3 * i + 1], a.o[3 * i + 2],
                  a.d[3 * i + 0], a.d[3 * i + 1], a.d[3 * i + 2], a.t_max[i],
                  a.any_hit[i] != 0, a.meta, a.n_rows, istack, lstack,
                  a.touched)) {
      while (ray.step(a.rows, a.meta, a.child_leaf, a.n_rows, istack, lstack,
                      a.touched)) {
      }
    }
    r = ray.result();
  } else {
    NearEntry stack[kMaxStack];
    V1Ray<kLeaf, kWinner> ray;
    if (ray.start(a.o[3 * i + 0], a.o[3 * i + 1], a.o[3 * i + 2],
                  a.d[3 * i + 0], a.d[3 * i + 1], a.d[3 * i + 2], a.t_max[i],
                  a.any_hit[i] != 0)) {
      while (ray.step(a.rows, a.meta, a.n_rows, stack, a.touched)) {
      }
    }
    r = ray.result();
  }
  a.t_out[i] = r.t;
  a.tri_out[i] = r.tri;
  if (a.steps_out != nullptr) a.steps_out[i] = r.steps;
}

using Kernel = void (*)(Args);

// Picks the v1 instantiation of a template (called by dispatch_v1).
struct PickV1 {
  Kernel kernel = nullptr;

  template <int kLeaf, int kWinner>
  void run() {
    kernel = traverse_kernel<1, kLeaf, kWinner>;
  }
};

// The kernel of (kernel, leaf, winner), or null for a combination the
// kernels do not offer.
Kernel pick(int kernel, int leaf, int winner) {
  if (kernel == 2) {
    return leaf == kLeafWatertight && winner == kWinnerSlot
               ? traverse_kernel<2, kLeafWatertight, kWinnerSlot>
               : nullptr;
  }
  PickV1 f;
  return kernel == 1 && dispatch_v1(leaf, winner, f) ? f.kernel : nullptr;
}

}  // namespace

// Plain C entry point for ctypes.  kernel: 1 (v1) or 2 (v2); leaf: 0
// watertight, 1 Moller-Trumbore (v1 only); winner: 0 lowest slot, 1 lowest
// id (v1 only).  child_leaf: the (n_rows,) child-leaf words v2 reads (may
// be null for v1).  steps_out and touched may be null (touched: see
// traverse_body.cuh, touch_row).  Launches on `stream` (PyTorch's current
// stream), does not synchronise, allocates nothing, and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a combination the
// kernels do not offer.
extern "C" int shimmer_traverse_launch(int kernel, int leaf, int winner,
                                       const float* rows, const int* meta,
                                       const int* child_leaf, int n_rows,
                                       const float* o,
                                       const float* d, const float* t_max,
                                       const uint8_t* any_hit, float* t_out,
                                       int* tri_out, int* steps_out,
                                       uint8_t* touched, int n, void* stream) {
  const Kernel k = pick(kernel, leaf, winner);
  if (k == nullptr || (kernel == 2 && child_leaf == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const Args a{rows,  meta,    child_leaf, n_rows,  o,         d,       t_max,
                 any_hit, t_out, tri_out,    steps_out, touched, n};
    const int blocks = (n + kThreads - 1) / kThreads;
    k<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of a kernel (arguments as above), from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor; -1 for a combination the
// kernels do not offer.
extern "C" int shimmer_traverse_blocks_per_sm(int kernel, int leaf, int winner) {
  const Kernel k = pick(kernel, leaf, winner);
  int blocks = -1;
  if (k == nullptr ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kThreads, 0) !=
          cudaSuccess) {
    return -1;
  }
  return blocks;
}

extern "C" int shimmer_traverse_max_stack() { return kMaxStack; }
