// Test-only host build of the traversal kernels' per-ray bodies.
//
// The CPU tests compile this file with g++ (-ffp-contract=off, no FMA) and
// call it through ctypes, so the kernels' own traversal logic
// (traverse_body.cuh, traverse_v2_body.cuh) is checked against the plain
// torch version on a machine without a GPU.  The render path never loads
// it.  Arguments as traverse.cu's shimmer_traverse_launch, less the stream:
// kernel 1 or 2; leaf 0 watertight, 1 Moller-Trumbore (v1 only); winner 0
// lowest slot, 1 lowest id (v1 only); child_leaf the child-leaf words (v2;
// may be null for v1); touched may be null.  stack_peak, when not null,
// receives each ray's largest internal stack depth, and leaf_peak (v2
// only; 0 under v1) its largest leaf backlog.  Returns 0, or -1 for a
// combination the kernels do not offer.

#include "traverse_v2_body.cuh"

namespace {

using namespace shimmer;

struct Rays {
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
  int* stack_peak;
  int* leaf_peak;

  void store(int i, const RayResult& r, int peak, int lpeak) const {
    t_out[i] = r.t;
    tri_out[i] = r.tri;
    steps_out[i] = r.steps;
    if (stack_peak != nullptr) stack_peak[i] = peak;
    if (leaf_peak != nullptr) leaf_peak[i] = lpeak;
  }

  void run_v2() const {
    V2Entry istack[kMaxStack];
    int lstack[kLeafStack];
    for (int i = 0; i < n; ++i) {
      V2Ray ray;
      int peak = 0, lpeak = 0;
      if (ray.start(o[3 * i + 0], o[3 * i + 1], o[3 * i + 2], d[3 * i + 0],
                    d[3 * i + 1], d[3 * i + 2], t_max[i], any_hit[i] != 0,
                    meta, n_rows, istack, lstack, touched)) {
        do {
          peak = ray.sp > peak ? ray.sp : peak;
          lpeak = ray.lsp > lpeak ? ray.lsp : lpeak;
        } while (ray.step(rows, meta, child_leaf, n_rows, istack, lstack,
                          touched));
      }
      store(i, ray.result(), peak, lpeak);
    }
  }

  // The v1 body (called by dispatch_v1).
  template <int kLeaf, int kWinner>
  void run() const {
    NearEntry stack[kMaxStack];
    for (int i = 0; i < n; ++i) {
      V1Ray<kLeaf, kWinner> ray;
      int peak = 0;
      if (ray.start(o[3 * i + 0], o[3 * i + 1], o[3 * i + 2], d[3 * i + 0],
                    d[3 * i + 1], d[3 * i + 2], t_max[i], any_hit[i] != 0)) {
        while (ray.step(rows, meta, n_rows, stack, touched)) {
          peak = ray.sp > peak ? ray.sp : peak;
        }
      }
      store(i, ray.result(), peak, 0);
    }
  }
};

}  // namespace

extern "C" int shimmer_traverse_host(int kernel, int leaf, int winner,
                                     const float* rows, const int* meta,
                                     const int* child_leaf, int n_rows,
                                     const float* o, const float* d,
                                     const float* t_max,
                                     const uint8_t* any_hit, float* t_out,
                                     int* tri_out, int* steps_out,
                                     uint8_t* touched, int n, int* stack_peak,
                                     int* leaf_peak) {
  const Rays rays{rows,    meta,      child_leaf, n_rows, o, d,
                  t_max,   any_hit,   t_out,      tri_out, steps_out,
                  touched, n,         stack_peak, leaf_peak};
  if (kernel == 2) {
    if (leaf != kLeafWatertight || winner != kWinnerSlot || child_leaf == nullptr) {
      return -1;
    }
    rays.run_v2();
    return 0;
  }
  return kernel == 1 && dispatch_v1(leaf, winner, rays) ? 0 : -1;
}

extern "C" int shimmer_traverse_max_stack() { return kMaxStack; }

extern "C" int shimmer_traverse_leaf_stack() { return kLeafStack; }
