// BVH8 closest-hit / any-hit traversal kernel for Hopper (sm_90a).
//
// Replaces shimmer_tpu/ops/pallas/traverse.py::_traverse_kernel (the v1
// packet kernel).  The TPU kernel's structure (128-ray packets sharing one
// stack, 4 interleaved chains, the (8, 128) tiles8 layout, VMEM residency)
// answers TPU constraints and is not carried over.  Here one thread traces
// one ray with its own stack (traverse_body.cuh), 128 threads per block.
//
// What bounds it on the H100: chains of dependent row reads (each visit
// needs the previous row's result to pick the next row) and warp
// divergence (the 32 rays of a warp visit different rows and different
// numbers of rows), not FLOPs.  The design answer for now: rows8 stays in
// global memory and is read through the read-only path (__ldg on
// const __restrict__ pointers); the 39 MB table of the bench scene fits in
// the 50 MB L2, so it can stay resident there across launches (the L2 hit
// rate is not measured yet).  Warp-cooperative node
// tests and live-lane launches are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
// (see shimmer_tpu_torch/ops/traverse.py).  -fmad=false keeps the
// watertight test bit-identical to the torch re-intersection.

#include <cuda_runtime.h>

#include "traverse_body.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    traverse_kernel(const float* __restrict__ rows,
                    const int* __restrict__ meta, int n_rows,
                    const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ t_max,
                    const uint8_t* __restrict__ any_hit,
                    float* __restrict__ t_out, int* __restrict__ tri_out,
                    int* __restrict__ steps_out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const shimmer::RayResult r = shimmer::traverse_ray(
      rows, meta, n_rows, o[3 * i + 0], o[3 * i + 1], o[3 * i + 2],
      d[3 * i + 0], d[3 * i + 1], d[3 * i + 2], t_max[i], any_hit[i] != 0);
  t_out[i] = r.t;
  tri_out[i] = r.tri;
  if (steps_out != nullptr) steps_out[i] = r.steps;
}

}  // namespace

// Plain C entry point for ctypes.  Launches on `stream` (PyTorch's current
// stream), does not synchronise, allocates nothing, and returns
// cudaGetLastError() so the caller sees a refused launch.
extern "C" int shimmer_traverse_launch(const float* rows, const int* meta,
                                       int n_rows, const float* o,
                                       const float* d, const float* t_max,
                                       const uint8_t* any_hit, float* t_out,
                                       int* tri_out, int* steps_out, int n,
                                       void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    traverse_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        rows, meta, n_rows, o, d, t_max, any_hit, t_out, tri_out, steps_out,
        n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int shimmer_traverse_max_stack() { return shimmer::kMaxStack; }
