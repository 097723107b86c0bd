// Test-only host build of the traversal kernels' per-ray bodies.
//
// The CPU tests compile this file with g++ (-ffp-contract=off, no FMA) and
// call it through ctypes, so the kernels' own traversal logic
// (traverse_body.cuh, traverse_v2_body.cuh) is checked against the plain
// torch version on a machine without a GPU.  The render path never loads
// it.  Arguments as traverse.cu's shimmer_traverse_launch, less the stream:
// kernel 1 or 2; leaf 0 watertight, 1 Moller-Trumbore (v1 only); winner 0
// lowest slot, 1 lowest id (v1 only); touched may be null.  Returns 0, or
// -1 for a combination the kernels do not offer.

#include "traverse_v2_body.cuh"

namespace {

template <typename Body>
void run(Body body, const float* rows, const int* meta, int n_rows,
         const float* o, const float* d, const float* t_max,
         const uint8_t* any_hit, float* t_out, int* tri_out, int* steps_out,
         uint8_t* touched, int n) {
  for (int i = 0; i < n; ++i) {
    const shimmer::RayResult r =
        body(rows, meta, n_rows, o[3 * i + 0], o[3 * i + 1], o[3 * i + 2],
             d[3 * i + 0], d[3 * i + 1], d[3 * i + 2], t_max[i],
             any_hit[i] != 0, touched);
    t_out[i] = r.t;
    tri_out[i] = r.tri;
    steps_out[i] = r.steps;
  }
}

}  // namespace

extern "C" int shimmer_traverse_host(int kernel, int leaf, int winner,
                                     const float* rows, const int* meta,
                                     int n_rows, const float* o,
                                     const float* d, const float* t_max,
                                     const uint8_t* any_hit, float* t_out,
                                     int* tri_out, int* steps_out,
                                     uint8_t* touched, int n) {
  using namespace shimmer;
#define SHIMMER_RUN(fn)                                                     \
  run(fn, rows, meta, n_rows, o, d, t_max, any_hit, t_out, tri_out,        \
      steps_out, touched, n)
  if (kernel == 2 && leaf == kLeafWatertight && winner == kWinnerSlot) {
    SHIMMER_RUN(traverse_ray_v2);
  } else if (kernel == 1 && leaf == kLeafMT) {
    if (winner == kWinnerMinId) {
      SHIMMER_RUN((traverse_ray<kLeafMT, kWinnerMinId>));
    } else {
      SHIMMER_RUN((traverse_ray<kLeafMT, kWinnerSlot>));
    }
  } else if (kernel == 1 && leaf == kLeafWatertight) {
    if (winner == kWinnerMinId) {
      SHIMMER_RUN((traverse_ray<kLeafWatertight, kWinnerMinId>));
    } else {
      SHIMMER_RUN((traverse_ray<kLeafWatertight, kWinnerSlot>));
    }
  } else {
    return -1;
  }
#undef SHIMMER_RUN
  return 0;
}

extern "C" int shimmer_traverse_max_stack() { return shimmer::kMaxStack; }

extern "C" int shimmer_traverse_leaf_stack() { return shimmer::kLeafStack; }
