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
// interleaved chains, packet groups, the (8, 128) tiles8 layout and its
// child-leaf column, VMEM residency and tile streaming) answers TPU
// constraints and is not carried over.  Here one thread traces one ray with
// its own stacks, 128 threads per block.
//
// What bounds them on the H100: chains of dependent row reads (each visit
// needs the previous row's result to pick the next row) and warp divergence
// (the 32 rays of a warp visit different rows and different numbers of
// rows), not FLOPs.  Where the rows come from sets the length of each link
// of the chain: the bench table (76,590 rows, 39 MB) fits in the 50 MB L2,
// the 1.3M-triangle table (295,034 rows, 152 MB) does not, though one
// batch's rays touch a far smaller part of it.  The design answer for now:
// rows8 stays in global memory, read through the read-only path (__ldg on
// const __restrict__ pointers), and the BFS row order keeps the top of the
// tree, which every ray visits, in a small contiguous prefix that stays hot
// in L2.  v2 adds two answers: ordered pops tighten t_best sooner, so fewer
// far subtrees are entered (fewer links in the chain), and the leaf backlog
// lets every loop step retire one internal and one leaf visit, so a warp's
// threads wait on one internal and one leaf row per step instead of
// splitting into internal-visit and leaf-visit groups; it pays with two
// more per-thread stacks (local memory) and up to eight child meta reads
// per internal visit.  Warp-cooperative node tests, node prefetch and
// live-lane launches are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
// (see shimmer_tpu_torch/ops/traverse.py).  -fmad=false keeps the leaf
// tests bit-identical to the plain torch version and the re-intersection.

#include <cuda_runtime.h>

#include "traverse_v2_body.cuh"

namespace {

constexpr int kThreads = 128;

template <int kKernel, int kLeaf, int kWinner>
__global__ void __launch_bounds__(kThreads)
    traverse_kernel(const float* __restrict__ rows,
                    const int* __restrict__ meta, int n_rows,
                    const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ t_max,
                    const uint8_t* __restrict__ any_hit,
                    float* __restrict__ t_out, int* __restrict__ tri_out,
                    int* __restrict__ steps_out, uint8_t* touched, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  shimmer::RayResult r;
  if constexpr (kKernel == 2) {
    r = shimmer::traverse_ray_v2(
        rows, meta, n_rows, o[3 * i + 0], o[3 * i + 1], o[3 * i + 2],
        d[3 * i + 0], d[3 * i + 1], d[3 * i + 2], t_max[i], any_hit[i] != 0,
        touched);
  } else {
    r = shimmer::traverse_ray<kLeaf, kWinner>(
        rows, meta, n_rows, o[3 * i + 0], o[3 * i + 1], o[3 * i + 2],
        d[3 * i + 0], d[3 * i + 1], d[3 * i + 2], t_max[i], any_hit[i] != 0,
        touched);
  }
  t_out[i] = r.t;
  tri_out[i] = r.tri;
  if (steps_out != nullptr) steps_out[i] = r.steps;
}

template <int kKernel, int kLeaf, int kWinner>
void launch(const float* rows, const int* meta, int n_rows, const float* o,
            const float* d, const float* t_max, const uint8_t* any_hit,
            float* t_out, int* tri_out, int* steps_out, uint8_t* touched,
            int n, cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  traverse_kernel<kKernel, kLeaf, kWinner><<<blocks, kThreads, 0, stream>>>(
      rows, meta, n_rows, o, d, t_max, any_hit, t_out, tri_out, steps_out,
      touched, n);
}

}  // namespace

// Plain C entry point for ctypes.  kernel: 1 (v1) or 2 (v2); leaf: 0
// watertight, 1 Moller-Trumbore (v1 only); winner: 0 lowest slot, 1 lowest
// id (v1 only).  steps_out and touched may be null (touched: see
// traverse_body.cuh, touch_row).  Launches on `stream` (PyTorch's current
// stream), does not synchronise, allocates nothing, and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a combination the
// kernels do not offer.
extern "C" int shimmer_traverse_launch(int kernel, int leaf, int winner,
                                       const float* rows, const int* meta,
                                       int n_rows, const float* o,
                                       const float* d, const float* t_max,
                                       const uint8_t* any_hit, float* t_out,
                                       int* tri_out, int* steps_out,
                                       uint8_t* touched, int n, void* stream) {
  using namespace shimmer;
  const bool v1 = kernel == 1 && (leaf == kLeafWatertight || leaf == kLeafMT) &&
                  (winner == kWinnerSlot || winner == kWinnerMinId);
  const bool v2 = kernel == 2 && leaf == kLeafWatertight && winner == kWinnerSlot;
  if (!v1 && !v2) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SHIMMER_LAUNCH(K, L, W)                                              \
  launch<K, L, W>(rows, meta, n_rows, o, d, t_max, any_hit, t_out, tri_out, \
                  steps_out, touched, n, s)
    if (v2) {
      SHIMMER_LAUNCH(2, kLeafWatertight, kWinnerSlot);
    } else if (leaf == kLeafMT) {
      if (winner == kWinnerMinId) {
        SHIMMER_LAUNCH(1, kLeafMT, kWinnerMinId);
      } else {
        SHIMMER_LAUNCH(1, kLeafMT, kWinnerSlot);
      }
    } else if (winner == kWinnerMinId) {
      SHIMMER_LAUNCH(1, kLeafWatertight, kWinnerMinId);
    } else {
      SHIMMER_LAUNCH(1, kLeafWatertight, kWinnerSlot);
    }
#undef SHIMMER_LAUNCH
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int shimmer_traverse_max_stack() { return shimmer::kMaxStack; }
